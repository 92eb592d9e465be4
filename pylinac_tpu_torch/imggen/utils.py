"""Scenario builders for synthetic QA images: the picket fence.

Port of ``generate_picketfence`` (``pylinac_tpu/imggen/utils.py:28``).
"""

from __future__ import annotations

from typing import Sequence

from .layers import Layer
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
