"""Scenario builders for synthetic QA images: the picket fence, the
Winston-Lutz set and the starshot.

Port of ``generate_picketfence`` (``pylinac_tpu/imggen/utils.py:28``),
``generate_winstonlutz`` (``:67-131``), ``generate_lightrad`` (``:134``),
``pixel_align`` (``:155``),
``_clean_make_dir`` (``:161``), ``_bb_offset_lui`` (``:170``) and the
multi-target generators ``generate_winstonlutz_multi_bb_single_field``
(``:182``), ``generate_winstonlutz_multi_bb_multi_field`` (``:236``) and
``generate_winstonlutz_cone`` (``:304``), and a copy of the starshot test
image ``make_starshot`` (``tests/models/test_starshot.py:10``), which
draws the bench's stars (``bench.py:314-331``).

Two private generators, test and smoke data: :func:`_generate_vmat_pair`
draws an open and a DMLC image of the DRGS and DRMLC tests as
``tests/models/test_vmat.py:19-74`` draws them, and of the DRCS test (which
the JAX package's tests do not draw: five segments at 50 mm between six
collimator spokes); :func:`_generate_dlg` draws the sweeping-gap image of
``tests/models/test_quart_dlg.py:104-131``.
"""

from __future__ import annotations

import os
import os.path as osp
import random
import shutil
from typing import Sequence

import numpy as np

from ..core import dcm
from ..core.array_utils import array_to_dicom
from ..core.geometry import cos as deg_cos, sin as deg_sin
from ..core.scale import MachineScale, convert
from .layers import (
    ArrayLayer,
    FilteredFieldLayer,
    GaussianFilterLayer,
    Layer,
    PerfectBBLayer,
    PerfectFieldLayer,
)
from .simulators import Simulator


def generate_picketfence(
    simulator: Simulator,
    field_layer,
    file_out: str,
    final_layers: list[Layer] | None = None,
    pickets: int = 11,
    picket_spacing_mm: int = 20,
    picket_width_mm: int = 2,
    picket_height_mm: int = 300,
    gantry_angle: int = 0,
    orientation=None,
    picket_offset_error: Sequence | None = None,
) -> None:
    """Write a mock picket fence DICOM image to ``file_out``."""
    from ..picketfence import Orientation

    orientation = orientation or Orientation.UP_DOWN
    picket_pos_mm = range(-int((pickets - 1) * picket_spacing_mm / 2),
                          int((pickets - 1) * picket_spacing_mm / 2) + 1,
                          picket_spacing_mm)
    for idx, pos in enumerate(picket_pos_mm):
        if picket_offset_error is not None:
            if len(picket_offset_error) != pickets:
                raise ValueError(
                    "The length of the error array must equal the number of pickets.")
            pos += picket_offset_error[idx]
        if orientation == Orientation.UP_DOWN:
            position = (0, pos)
            layout = (picket_height_mm, picket_width_mm)
        else:
            position = (pos, 0)
            layout = (picket_width_mm, picket_height_mm)
        simulator.add_layer(field_layer(field_size_mm=layout, cax_offset_mm=position))
    if final_layers is not None:
        for layer in final_layers:
            simulator.add_layer(layer)
    simulator.generate_dicom(file_out, gantry_angle=gantry_angle)


def generate_winstonlutz(
    simulator: Simulator,
    field_layer,
    dir_out: str,
    field_size_mm: tuple[float, float] = (30, 30),
    final_layers: list[Layer] | None = None,
    bb_size_mm: float = 5,
    offset_mm_left: float = 0,
    offset_mm_up: float = 0,
    offset_mm_in: float = 0,
    image_axes: Sequence[tuple[int, int, int]] = ((0, 0, 0), (90, 0, 0), (180, 0, 0), (270, 0, 0)),
    machine_scale: MachineScale = MachineScale.IEC61217,
    gantry_tilt: float = 0,
    gantry_sag: float = 0,
    clean_dir: bool = True,
    field_alpha: float = 1.0,
    bb_alpha: float = -0.5,
    tags: dict | None = None,
) -> list[str]:
    """Write a mock set of Winston-Lutz DICOM images, one per (gantry,
    collimator, couch) of ``image_axes``, with the BB at the given 3D offset
    from the isocentre, into ``dir_out``; returns the file names. The BB is
    projected with the analysis' own
    :func:`pylinac_tpu_torch.winston_lutz.bb_projection_with_rotation`."""
    from ..winston_lutz import bb_projection_with_rotation

    if field_alpha + bb_alpha > 1:
        raise ValueError("field_alpha and bb_alpha must sum to <=1")
    if field_alpha - bb_alpha < 0:
        raise ValueError("field_alpha and bb_alpha must have a sum >=0")
    if clean_dir and osp.isdir(dir_out):
        shutil.rmtree(dir_out)
    os.makedirs(dir_out, exist_ok=True)
    file_names = []
    for gantry_in, coll_in, couch_in in image_axes:
        gantry, coll, couch = convert(
            input_scale=machine_scale, output_scale=MachineScale.IEC61217,
            gantry=gantry_in, collimator=coll_in, rotation=couch_in)
        sim_single = type(simulator)(sid=simulator.sid)
        sim_single.add_layer(field_layer(
            field_size_mm=field_size_mm,
            cax_offset_mm=(gantry_sag * deg_sin(gantry), gantry_tilt * deg_cos(gantry)),
            alpha=field_alpha, rotation=coll))
        gplane_offset, long_offset = bb_projection_with_rotation(
            offset_left=offset_mm_left, offset_up=offset_mm_up,
            offset_in=offset_mm_in, gantry=gantry, couch=couch, sad=1000)
        sim_single.add_layer(PerfectBBLayer(
            # the layer's offset is (out, right): the negative long offset
            cax_offset_mm=(-long_offset, gplane_offset),
            bb_size_mm=bb_size_mm, alpha=bb_alpha))
        if final_layers is not None:
            for layer in final_layers:
                sim_single.add_layer(layer)
        file_name = (f"WL G={gantry}, C={coll}, P={couch}; Field={field_size_mm}mm; "
                     f"BB={bb_size_mm}mm @ left={offset_mm_left}, in={offset_mm_in}, "
                     f"up={offset_mm_up}.dcm")
        sim_single.generate_dicom(osp.join(dir_out, file_name),
                                  gantry_angle=gantry, coll_angle=coll,
                                  table_angle=couch, tags=tags)
        file_names.append(file_name)
    return file_names


def generate_lightrad(
    simulator: Simulator,
    field_layer=FilteredFieldLayer,
    file_out: str = "lightrad.dcm",
    final_layers: list[Layer] | None = None,
    field_size_mm: tuple[float, float] = (150, 150),
    cax_offset_mm: tuple[float, float] = (0, 0),
    bb_size_mm: float = 3,
    bb_positions=((-40, -40), (-40, 40), (40, -40), (40, 40)),
) -> None:
    """A light/rad image: an open field and fiducial BBs."""
    simulator.add_layer(field_layer(field_size_mm=field_size_mm, cax_offset_mm=cax_offset_mm))
    for bb in bb_positions:
        simulator.add_layer(PerfectBBLayer(bb_size_mm=bb_size_mm, cax_offset_mm=bb))
    if final_layers is not None:
        for layer in final_layers:
            simulator.add_layer(layer)
    simulator.generate_dicom(file_out)


def pixel_align(pixel_size: float, length_mm: float) -> float:
    """A physical length rounded to a whole number of pixels."""
    return round(length_mm / pixel_size) * pixel_size


def _clean_make_dir(dir_out: str, clean_dir: bool) -> None:
    if clean_dir and osp.isdir(dir_out):
        shutil.rmtree(dir_out)
    os.makedirs(dir_out, exist_ok=True)


def _bb_offset_lui(offset, rng: random.Random, jitter_mm: float) -> tuple[float, float, float]:
    """(left, up, in) of a [left, up, in] triple or a BBConfig-style dict,
    each jittered uniformly by up to ``jitter_mm`` from ``rng``."""
    if isinstance(offset, dict):
        left, up, inward = offset["offset_left_mm"], offset["offset_up_mm"], offset["offset_in_mm"]
    else:
        left, up, inward = offset[0], offset[1], offset[2]

    def jitter():
        return rng.uniform(-jitter_mm, jitter_mm) if jitter_mm else 0.0

    return left + jitter(), up + jitter(), inward + jitter()


def generate_winstonlutz_multi_bb_single_field(
    simulator: Simulator,
    field_layer,
    dir_out: str,
    offsets: Sequence,
    field_size_mm: tuple[float, float] = (30, 30),
    final_layers: list[Layer] | None = None,
    bb_size_mm: float = 5,
    image_axes: Sequence[tuple[int, int, int]] = ((0, 0, 0), (90, 0, 0), (180, 0, 0), (270, 0, 0)),
    gantry_tilt: float = 0,
    gantry_sag: float = 0,
    clean_dir: bool = True,
    jitter_mm: float = 0,
    seed: int = 1234,
) -> list[str]:
    """Write one image per axis of ``image_axes``: one open field and one
    BB per entry of ``offsets`` (a [left, up, in] triple or a BBConfig-style
    dict); returns the file names."""
    from ..winston_lutz import bb_projection_with_rotation

    rng = random.Random(seed)
    _clean_make_dir(dir_out, clean_dir)
    file_names = []
    for gantry, coll, couch in image_axes:
        sim_single = type(simulator)(sid=simulator.sid)
        sim_single.add_layer(field_layer(
            field_size_mm=field_size_mm,
            cax_offset_mm=(gantry_tilt * deg_cos(gantry), gantry_sag * deg_sin(gantry))))
        for offset in offsets:
            left, up, inward = _bb_offset_lui(offset, rng, jitter_mm)
            gplane_offset, long_offset = bb_projection_with_rotation(
                offset_left=left, offset_up=up, offset_in=inward,
                gantry=gantry, couch=couch, sad=1000)
            sim_single.add_layer(PerfectBBLayer(
                # the layer's offset is (out, right): the negative long offset
                cax_offset_mm=(-long_offset, gplane_offset), bb_size_mm=bb_size_mm))
        if final_layers is not None:
            for layer in final_layers:
                sim_single.add_layer(layer)
        file_name = (f"WL G={gantry}, C={coll}, P={couch}; "
                     f"Field={field_size_mm}mm; {len(offsets)} BBs.dcm")
        sim_single.generate_dicom(osp.join(dir_out, file_name), gantry_angle=gantry,
                                  coll_angle=coll, table_angle=couch)
        file_names.append(file_name)
    return file_names


def generate_winstonlutz_multi_bb_multi_field(
    simulator: Simulator,
    field_layer,
    dir_out: str,
    field_offsets: Sequence,
    bb_offsets: Sequence,
    field_size_mm: tuple[float, float] = (20, 20),
    final_layers: Sequence[Layer] | None = None,
    bb_size_mm: float = 5,
    image_axes: Sequence[tuple[int, int, int]] = ((0, 0, 0), (90, 0, 0), (180, 0, 0), (270, 0, 0)),
    gantry_tilt: float = 0,
    gantry_sag: float = 0,
    clean_dir: bool = True,
    jitter_mm: float = 0,
    align_to_pixels: bool = True,
    seed: int = 1234,
) -> list[str]:
    """Write one image per axis of ``image_axes``: one field per entry of
    ``field_offsets`` and one BB per entry of ``bb_offsets`` (each a
    [left, up, in] triple or a BBConfig-style dict), the multi-target
    multi-field session; returns the file names."""
    from ..winston_lutz import bb_projection_with_rotation

    rng = random.Random(seed)
    _clean_make_dir(dir_out, clean_dir)
    file_names = []
    for gantry, coll, couch in image_axes:
        sim_single = type(simulator)(sid=simulator.sid)
        for field_offset in field_offsets:
            left, up, inward = _bb_offset_lui(
                field_offset if isinstance(field_offset, dict) else list(field_offset),
                rng, jitter_mm)
            gplane_offset, long_offset = bb_projection_with_rotation(
                offset_left=left, offset_up=up, offset_in=inward,
                gantry=gantry, couch=couch, sad=1000)
            long_offset += gantry_tilt * deg_cos(gantry)
            gplane_offset += gantry_sag * deg_sin(gantry)
            if align_to_pixels:
                long_offset = pixel_align(sim_single.pixel_size, long_offset)
                gplane_offset = pixel_align(sim_single.pixel_size, gplane_offset)
            sim_single.add_layer(field_layer(
                field_size_mm=field_size_mm, cax_offset_mm=(-long_offset, gplane_offset)))
        for offset in bb_offsets:
            left, up, inward = _bb_offset_lui(offset, rng, jitter_mm)
            gplane_offset, long_offset = bb_projection_with_rotation(
                offset_left=left, offset_up=up, offset_in=inward,
                gantry=gantry, couch=couch, sad=1000)
            sim_single.add_layer(PerfectBBLayer(
                cax_offset_mm=(-long_offset, gplane_offset), bb_size_mm=bb_size_mm))
        if final_layers is not None:
            for layer in final_layers:
                sim_single.add_layer(layer)
        file_name = (f"WL G={gantry}, C={coll}, P={couch}; "
                     f"{len(field_offsets)} fields; {len(bb_offsets)} BBs.dcm")
        sim_single.generate_dicom(osp.join(dir_out, file_name), gantry_angle=gantry,
                                  coll_angle=coll, table_angle=couch)
        file_names.append(file_name)
    return file_names


def generate_winstonlutz_cone(
    simulator: Simulator,
    cone_layer,
    dir_out: str,
    cone_size_mm: float = 17.5,
    final_layers: list[Layer] | None = None,
    bb_size_mm: float = 5,
    offset_mm_left: float = 0,
    offset_mm_up: float = 0,
    offset_mm_in: float = 0,
    image_axes: Sequence[tuple[int, int, int]] = ((0, 0, 0), (90, 0, 0), (180, 0, 0), (270, 0, 0)),
    gantry_tilt: float = 0,
    gantry_sag: float = 0,
    clean_dir: bool = True,
) -> list[str]:
    """Write a Winston-Lutz set with a circular cone field in place of a
    jaw field; returns the file names."""
    from ..winston_lutz import bb_projection_with_rotation

    _clean_make_dir(dir_out, clean_dir)
    file_names = []
    for gantry, coll, couch in image_axes:
        sim_single = type(simulator)(sid=simulator.sid)
        sim_single.add_layer(cone_layer(
            cone_size_mm=cone_size_mm,
            cax_offset_mm=(gantry_tilt * deg_cos(gantry), gantry_sag * deg_sin(gantry))))
        gplane_offset, long_offset = bb_projection_with_rotation(
            offset_left=offset_mm_left, offset_up=offset_mm_up, offset_in=offset_mm_in,
            gantry=gantry, couch=couch, sad=1000)
        sim_single.add_layer(PerfectBBLayer(
            cax_offset_mm=(-long_offset, gplane_offset), bb_size_mm=bb_size_mm))
        if final_layers is not None:
            for layer in final_layers:
                sim_single.add_layer(layer)
        file_name = (f"WL G={gantry}, C={coll}, P={couch}; "
                     f"Cone={cone_size_mm}mm; BB={bb_size_mm}mm.dcm")
        sim_single.generate_dicom(osp.join(dir_out, file_name), gantry_angle=gantry,
                                  coll_angle=coll, table_angle=couch)
        file_names.append(file_name)
    return file_names


def make_starshot(out_dir, center=(500, 520), n_spokes=5, angles_offset=10.0,
                  size=(1000, 1040), spoke_sigma_px=4.0, dpi=100.0, noise=0.0,
                  wobble_shift_px=0.0, name: str = "star.dcm", seed: int = 42,
                  half_spoke: float = 0.0, invert: bool = False):
    """A synthetic starshot DICOM in ``out_dir``: ``n_spokes`` Gaussian lines
    through ``center`` (x, y px), every other one shifted by
    ``wobble_shift_px`` across itself to make a wobble, scaled to a peak of
    3000 as uint16 at SID 1000, with Gaussian noise of sigma ``noise`` from
    ``seed``. The defaults draw the test image; the port adds
    ``half_spoke``, the relative height of one more spoke drawn on one side
    of the centre only (an odd peak that fails the first combos of the
    retry ladder), and ``invert``, which stores 3000 minus the image (dark
    spokes, as on film). Returns the file's path."""
    h, w = size
    cy, cx = center[1], center[0]
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.zeros((h, w))
    rng = np.random.default_rng(seed)
    for i in range(n_spokes):
        theta = np.deg2rad(angles_offset + i * 180.0 / n_spokes)
        off = wobble_shift_px * (1 if i % 2 else -1)
        dx, dy = np.cos(theta), np.sin(theta)
        d = np.abs(-(yy - cy - off * dx) * dx + (xx - cx + off * dy) * dy)
        img += np.exp(-0.5 * (d / spoke_sigma_px) ** 2)
    if half_spoke:
        theta = np.deg2rad(angles_offset + 90.0 / n_spokes)
        dx, dy = np.cos(theta), np.sin(theta)
        d = np.abs(-(yy - cy) * dx + (xx - cx) * dy)
        ahead = (xx - cx) * dx + (yy - cy) * dy > 0
        img += half_spoke * ahead * np.exp(-0.5 * (d / spoke_sigma_px) ** 2)
    img = img / img.max() * 3000
    if noise:
        img += rng.normal(0, noise, img.shape)
    if invert:
        img = 3000 - img
    arr = np.clip(img, 0, 65535).astype(np.uint16)
    ds = array_to_dicom(arr, sid=1000.0, gantry=0, coll=0, couch=0, dpi=dpi)
    path = osp.join(str(out_dir), name)
    dcm.dcmwrite(path, ds)
    return path


DRGS_OFFSETS_MM = (-60, -40, -20, 0, 20, 40, 60)
DRMLC_OFFSETS_MM = (-45, -15, 15, 45)
DRCS_ROI_ANGLES = (-120, -60, 0, 60, 120)
DRCS_SPOKES = (150, 90, 30, 330, 270, 210)  # the nominal collimator angles


def _spoke_layer(image_angle: float, radius_mm: float, length_mm: float, width_mm: float,
                 alpha: float) -> PerfectFieldLayer:
    """A ``length_mm`` x ``width_mm`` field centred ``radius_mm`` from the
    CAX, its long side along ``image_angle`` (degrees of atan2(dy, dx), y
    down)."""
    theta = np.deg2rad(image_angle)
    return PerfectFieldLayer(field_size_mm=(width_mm, length_mm),
                             cax_offset_mm=(radius_mm * np.sin(theta), radius_mm * np.cos(theta)),
                             alpha=alpha, rotation=-image_angle)


def _generate_vmat_pair(test: str, simulator: Simulator, dir_out: str,
                        segment_errors: Sequence[float] | None = None,
                        spoke_offset_deg: float = 0.0) -> list[str]:
    """Write an open and a DMLC image of the ``test`` ("drgs", "drmlc" or
    "drcs") into ``dir_out``; returns [open path, DMLC path]. Each segment
    is drawn ``segment_errors`` % hot (default 0); the DRCS spokes turn by
    ``spoke_offset_deg``."""
    sim_open, sim_dmlc = (type(simulator)(sid=simulator.sid) for _ in range(2))
    if test == "drgs":
        offsets, open_mm, strip_mm = DRGS_OFFSETS_MM, (150, 170), (150, 15)
    elif test == "drmlc":
        offsets, open_mm, strip_mm = DRMLC_OFFSETS_MM, (150, 130), (150, 22)
    elif test == "drcs":
        offsets, open_mm = DRCS_ROI_ANGLES, (150, 150)
    else:
        raise ValueError(f"Unknown VMAT test {test}")
    errors = segment_errors or [0] * len(offsets)
    sim_open.add_layer(PerfectFieldLayer(field_size_mm=open_mm))
    if test == "drcs":
        sim_dmlc.add_layer(PerfectFieldLayer(field_size_mm=open_mm, alpha=0.5))
        for nominal in DRCS_SPOKES:
            sim_dmlc.add_layer(_spoke_layer(-nominal - 90 - spoke_offset_deg, 50, 60, 2, 0.3))
        for angle, err in zip(offsets, errors):
            if err:
                sim_dmlc.add_layer(_spoke_layer(-angle - 90, 50, 44, 12, 0.5 * err / 100))
    else:
        for offset, err in zip(offsets, errors):
            sim_dmlc.add_layer(PerfectFieldLayer(field_size_mm=strip_mm, cax_offset_mm=(0, offset),
                                                 alpha=0.5 * (1 + err / 100)))
    paths = []
    for sim, name in ((sim_open, "open"), (sim_dmlc, "dmlc")):
        sim.add_layer(GaussianFilterLayer(sigma_mm=1))
        path = osp.join(dir_out, f"{test}_{name}.dcm")
        sim.generate_dicom(path)
        paths.append(path)
    return paths


def _generate_dlg(simulator: Simulator, path: str,
                  gaps: Sequence[float] = (-0.4, -0.6, -0.8, -1.0, -1.2),
                  field_mm: float = 100.0) -> None:
    """A sweeping-gap image: in each of ``len(gaps)`` bands of the field a
    dark line at the centre, 300 |gap| deep (the bands in ascending gap
    order, top first)."""
    h, w = simulator.shape
    dpmm = 1 / simulator.pixel_size
    arr = np.full((h, w), 500.0)
    roi = field_mm / len(gaps)
    cy, cx = h / 2, w / 2
    yy = (np.arange(h) - cy) / dpmm
    for idx, gap in enumerate(sorted(gaps)):
        upper = field_mm / 2 - idx * roi
        lower = field_mm / 2 - (idx + 1) * roi
        band = (yy > lower) & (yy <= upper)
        arr[np.ix_(band, np.arange(int(cx - 2), int(cx + 2)))] -= 300 * abs(gap)
    simulator.add_layer(ArrayLayer((arr * 50).astype(np.uint16)))
    simulator.add_layer(GaussianFilterLayer(sigma_mm=0.5))
    simulator.generate_dicom(path)
