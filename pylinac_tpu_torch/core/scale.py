"""Machine coordinate scales: IEC 61217, Elekta and Varian IEC, Varian
Standard.

Port of ``pylinac_tpu/core/scale.py`` (``wrap360`` ``:11``, ``wrap180``
``:16``, ``MachineScale`` ``:33``,
``convert`` ``:58``, ``MachineScaleEnumStr`` ``:71``), numpy only.
"""

from __future__ import annotations

from enum import Enum


def wrap360(value):
    """Wrap to [0, 360)."""
    return value % 360


def wrap180(value):
    """Wrap to [-180, 180)."""
    return wrap360(value + 180) - 180


def _noop(value):
    return value


def _mirror_360(value):
    return wrap360(-value)


def _shift_and_mirror_360(value):
    return wrap360(180 - value)


class MachineScale(Enum):
    """Machine scales; each maps per-axis conversions to and from IEC 61217."""

    IEC61217 = {
        "gantry_to_iec": _noop, "collimator_to_iec": _noop, "rotation_to_iec": _noop,
        "gantry_from_iec": _noop, "collimator_from_iec": _noop, "rotation_from_iec": _noop,
    }
    ELEKTA_IEC = {
        "gantry_to_iec": _noop, "collimator_to_iec": _noop, "rotation_to_iec": _mirror_360,
        "gantry_from_iec": _noop, "collimator_from_iec": _noop, "rotation_from_iec": _mirror_360,
    }
    VARIAN_IEC = {
        "gantry_to_iec": _noop, "collimator_to_iec": _noop, "rotation_to_iec": _mirror_360,
        "gantry_from_iec": _noop, "collimator_from_iec": _noop, "rotation_from_iec": _mirror_360,
    }
    VARIAN_STANDARD = {
        "gantry_to_iec": _shift_and_mirror_360,
        "collimator_to_iec": _shift_and_mirror_360,
        "rotation_to_iec": _shift_and_mirror_360,
        "gantry_from_iec": _shift_and_mirror_360,
        "collimator_from_iec": _shift_and_mirror_360,
        "rotation_from_iec": _shift_and_mirror_360,
    }


def convert(input_scale: MachineScale, output_scale: MachineScale,
            gantry, collimator, rotation):
    """(gantry, collimator, rotation) from one machine scale to another,
    through IEC 61217."""
    g = input_scale.value["gantry_to_iec"](gantry)
    c = input_scale.value["collimator_to_iec"](collimator)
    r = input_scale.value["rotation_to_iec"](rotation)
    return (
        output_scale.value["gantry_from_iec"](g),
        output_scale.value["collimator_from_iec"](c),
        output_scale.value["rotation_from_iec"](r),
    )


class MachineScaleEnumStr(str, Enum):
    """A string enum of machine scales, empty as in the JAX package."""
