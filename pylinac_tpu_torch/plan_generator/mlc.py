"""MLC control-point shapes for QA plan generation.

Carried over from ``pylinac_tpu/plan_generator/mlc.py``: ``MLCShaper``
``:15``, ``next_sacrifice_shift`` ``:153``, ``interpolate_control_points``
``:172`` and ``split_sacrifice_travel`` ``:206``, unchanged: strip and
rectangle shapes with transition doses and sacrificial-leaf moves for
dose-rate and MLC-speed modulation, host Python.
"""

from __future__ import annotations

import numpy as np

from ..core import validators


class MLCShaper:
    """Generates MLC positions and metersets to create patterns, including
    sacrificial-leaf movements."""

    def __init__(self, leaf_y_positions: list[float], max_mlc_position: float,
                 max_overtravel_mm: float,
                 sacrifice_gap_mm: float | None = None,
                 sacrifice_max_move_mm: float | None = None):
        self.leaf_y_positions = leaf_y_positions
        self.max_mlc_position = max_mlc_position
        self.sacrifice_gap = sacrifice_gap_mm
        self.sacrifice_max_move_mm = sacrifice_max_move_mm
        self.max_overtravel_mm = max_overtravel_mm
        self.control_points: list[list[float]] = []
        self.metersets: list[float] = []

    @property
    def centers(self) -> list[float]:
        """Leaf center y-positions."""
        return [float(np.mean([s, e]))
                for s, e in zip(self.leaf_y_positions[:-1],
                                self.leaf_y_positions[1:])]

    @property
    def num_leaves(self) -> int:
        return int((len(self.leaf_y_positions) - 1) * 2)

    @property
    def num_pairs(self) -> int:
        return int(self.num_leaves / 2)

    def as_control_points(self) -> list[list[float]]:
        return self.control_points

    def as_metersets(self) -> list[float]:
        return self.metersets

    def add_rectangle(self, left_position: float, right_position: float,
                      x_outfield_position: float, top_position: float,
                      bottom_position: float, outer_strip_width: float,
                      meterset_at_target: float,
                      meterset_transition: float = 0,
                      sacrificial_distance: float = 0,
                      initial_sacrificial_gap: float | None = None) -> None:
        """A rectangle: the leaves whose centres lie between ``bottom_position``
        and ``top_position`` open from ``left_position`` to ``right_position``;
        the others close at ``x_outfield_position``, ``outer_strip_width``
        apart."""
        positions: list = [0] * self.num_leaves
        for idx, leaf_center in enumerate(self.centers):
            infield = bottom_position < leaf_center < top_position
            positions[idx] = left_position if infield else x_outfield_position
            positions[idx + self.num_pairs] = (right_position if infield
                                               else x_outfield_position)
            if not infield:
                positions[idx] -= outer_strip_width / 2
                positions[idx + self.num_pairs] += outer_strip_width / 2
        if initial_sacrificial_gap:
            positions[0] -= initial_sacrificial_gap / 2
            positions[self.num_pairs - 1] -= initial_sacrificial_gap / 2
            positions[self.num_pairs] += initial_sacrificial_gap / 2
            positions[-1] += initial_sacrificial_gap / 2
        start_meterset = self.metersets[-1] if self.metersets else 0
        end_meterset = start_meterset + meterset_at_target + meterset_transition
        if end_meterset > 1.0:
            raise ValueError("Meterset exceeds 1.0")
        if sacrificial_distance > 0 and meterset_transition == 0:
            raise ValueError(
                "Sacrificial distance > 0 but transition meterset was 0. "
                "Sacrifices are only used in transitions.")
        if sacrificial_distance > 0 and initial_sacrificial_gap is not None:
            raise ValueError(
                "Cannot specify both a sacrificial distance and an initial "
                "sacrificial gap.")
        if initial_sacrificial_gap and len(self.control_points) > 0:
            raise ValueError(
                "Cannot specify an initial sacrificial gap if there are "
                "already control points.")
        if initial_sacrificial_gap and meterset_transition:
            raise ValueError(
                "Cannot specify an initial sacrificial gap if there is a "
                "transition dose.")
        if meterset_transition > 0:
            if len(self.control_points) == 0:
                raise ValueError(
                    "Cannot have a transition without a starting control "
                    "point. Add a control point first.")
            if sacrificial_distance > 0:
                sacrifice_chunks = split_sacrifice_travel(
                    sacrificial_distance, self.sacrifice_max_move_mm)
                interpolation_ratios = list(np.cumsum(
                    [m / sum(sacrifice_chunks) for m in sacrifice_chunks]))
                interpolated = interpolate_control_points(
                    control_point_start=self.control_points[-1],
                    control_point_end=positions,
                    interpolation_ratios=interpolation_ratios,
                    sacrifice_chunks=sacrifice_chunks,
                    max_overtravel=self.max_overtravel_mm)
                self.control_points.extend(interpolated)
                self.metersets.extend(
                    [start_meterset + meterset_transition * ratio
                     for ratio in interpolation_ratios])
            else:
                self.control_points.append(positions)
                self.metersets.append(start_meterset + meterset_transition)
        else:
            self.control_points.append(positions)
            self.metersets.append(start_meterset)
            if end_meterset != start_meterset:
                self.control_points.append(positions)
                self.metersets.append(end_meterset)

    def park(self, meterset: float = 0) -> None:
        """Park the MLC leaves fully open."""
        self.add_rectangle(
            left_position=-self.max_mlc_position,
            right_position=self.max_mlc_position,
            x_outfield_position=-200,
            top_position=max(self.leaf_y_positions),
            bottom_position=min(self.leaf_y_positions),
            outer_strip_width=1,
            meterset_at_target=meterset)

    def add_strip(self, position_mm: float, strip_width_mm: float,
                  meterset_at_target: float, meterset_transition: float = 0,
                  sacrificial_distance_mm: float = 0,
                  initial_sacrificial_gap_mm: float | None = None) -> None:
        """Single strip centered at ``position_mm`` using all the leaves."""
        self.add_rectangle(
            left_position=position_mm - strip_width_mm / 2,
            right_position=position_mm + strip_width_mm / 2,
            x_outfield_position=-200,
            top_position=max(self.leaf_y_positions),
            bottom_position=min(self.leaf_y_positions),
            outer_strip_width=1,
            meterset_at_target=meterset_at_target,
            meterset_transition=meterset_transition,
            sacrificial_distance=sacrificial_distance_mm,
            initial_sacrificial_gap=initial_sacrificial_gap_mm)


def next_sacrifice_shift(current_position_mm: float, travel_mm: float,
                         x_width_mm: float, other_mlc_position: float,
                         max_overtravel_mm: float) -> float:
    """Next sacrificial-leaf shift; oscillates within the travel range."""
    largest_travel_allowed = max_overtravel_mm + abs(
        other_mlc_position - current_position_mm)
    if travel_mm > largest_travel_allowed:
        raise ValueError("Travel distance exceeds allowed range")
    if x_width_mm < max_overtravel_mm:
        raise ValueError("Max overtravel exceeds MLC width")
    movement_direction = 1 if current_position_mm < other_mlc_position else -1
    target_shift = movement_direction * travel_mm
    if (target_shift + current_position_mm < -x_width_mm / 2) or (
            target_shift + current_position_mm > x_width_mm / 2):
        target_shift = -movement_direction * travel_mm
    return target_shift


def interpolate_control_points(control_point_start: list[float],
                               control_point_end: list[float],
                               interpolation_ratios: list[float],
                               sacrifice_chunks: list[float],
                               max_overtravel: float) -> list[list[float]]:
    """Interpolate between control points, injecting sacrificial moves into
    the first and last leaf pairs."""
    if len(control_point_start) != len(control_point_end):
        raise ValueError("Control points must be the same length")
    if any(r < 0 or r > 1.001 for r in interpolation_ratios):
        raise ValueError("Interpolation ratios must be between 0 and 1")
    if len(interpolation_ratios) == 0:
        raise ValueError("Interpolation ratios must be provided")
    if len(interpolation_ratios) != len(sacrifice_chunks):
        raise ValueError(
            "Interpolation ratios must be the same length as the sacrifice chunks")
    num_leaves = int(len(control_point_start) / 2)
    all_cps = [control_point_start]
    for ratio, sacrifice in zip(interpolation_ratios, sacrifice_chunks):
        last_cp = all_cps[-1]
        sacrificial_shift = next_sacrifice_shift(
            current_position_mm=last_cp[0], travel_mm=sacrifice,
            x_width_mm=400, other_mlc_position=last_cp[1],
            max_overtravel_mm=max_overtravel)
        new_cp = [start + (end - start) * ratio
                  for start, end in zip(control_point_start, control_point_end)]
        new_cp[0] = last_cp[0] + sacrificial_shift
        new_cp[num_leaves - 1] = last_cp[num_leaves - 1] + sacrificial_shift
        new_cp[num_leaves] = last_cp[num_leaves] + sacrificial_shift
        new_cp[-1] = last_cp[-1] + sacrificial_shift
        all_cps.append(new_cp)
    return all_cps[1:]


def split_sacrifice_travel(distance: float, max_travel: float) -> list[float]:
    """Split a travel distance into max-travel chunks + remainder."""
    validators.is_positive(distance)
    validators.is_positive(max_travel)
    result = []
    while distance >= max_travel:
        result.append(max_travel)
        distance -= max_travel
    if distance > 0:
        result.append(distance)
    return result
