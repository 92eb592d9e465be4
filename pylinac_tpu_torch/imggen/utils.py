"""Scenario builders for synthetic QA images: the picket fence and the
Winston-Lutz set.

Port of ``generate_picketfence`` (``pylinac_tpu/imggen/utils.py:28``) and
``generate_winstonlutz`` (``:67-131``).
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
from typing import Sequence

from ..core.geometry import cos as deg_cos, sin as deg_sin
from ..core.scale import MachineScale, convert
from .layers import Layer, PerfectBBLayer
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
