"""Fluence maps of an RT plan's beams.

Port of ``pylinac_tpu/plan_generator/fluence.py`` (``generate_fluences``
``:26-96``). The host reads each beam's control points, turns the leaf
positions into bins with ``searchsorted`` and maps the leaf pairs onto the
rows; :func:`..ops.fluence.interval_fluence` accumulates the apertures on
``device``, one call for each MLC stack of a beam, in XLA's CPU order on
both devices, so the float32 map equals JAX's bit for bit. The map comes
back to the host and is cast to ``dtype`` only then, as in JAX; a dual-stack
(Halcyon) beam keeps the elementwise minimum of its stacks.
``plot_fluences`` (``:99``) draws one figure a beam of those maps, its
matplotlib imported inside; ``device`` is where the maps are made.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.utilities import resolve_device
from ..ops.fluence import interval_fluence


def _iter_beam_mlc_stacks(beam) -> list[tuple[str, int, list[float]]]:
    """(device type, number of pairs, boundaries) of each MLC stack of a beam."""
    stacks = []
    for bld in beam.BeamLimitingDeviceSequence:
        if "MLC" in str(bld.RTBeamLimitingDeviceType):
            stacks.append((str(bld.RTBeamLimitingDeviceType),
                           int(bld.NumberOfLeafJawPairs),
                           [float(b) for b in bld.LeafPositionBoundaries]))
    return stacks


def _leaf_edges(cps, mlc_id: str, n_pairs: int) -> tuple[np.ndarray, np.ndarray]:
    """(P, S) bank B and bank A positions of one stack at every control
    point; DICOM gives every position at control point 0, and a position
    holds until a later control point gives it again."""
    lefts = np.zeros((n_pairs, len(cps)))
    rights = np.zeros((n_pairs, len(cps)))
    cur_b = cur_a = np.zeros(n_pairs)
    for cp_idx, cp in enumerate(cps):
        bldps = cp.get("BeamLimitingDevicePositionSequence")
        if cp_idx == 0 or bldps is not None:
            positions = [bld.LeafJawPositions for bld in bldps
                         if str(bld.RTBeamLimitingDeviceType) == mlc_id]
            if positions:
                arr = np.asarray(positions[0], dtype=float)
                cur_b = arr[:n_pairs]
                cur_a = arr[n_pairs:]
        lefts[:, cp_idx] = cur_b
        rights[:, cp_idx] = cur_a
    return lefts, rights


def generate_fluences(rt_plan, width_mm: float, resolution_mm: float = 0.1,
                      dtype=np.uint16, device=None) -> np.ndarray:
    """Fluence maps of shape (beams, height, width) from an RT plan, as a
    host array of ``dtype``; the accumulation runs on ``device`` (``None``
    means CUDA)."""
    device = resolve_device(device, "generate_fluences")
    beams = list(getattr(rt_plan, "BeamSequence", []) or [])
    if not beams:
        return np.empty(0)

    # the y axis spans every stack's leaf boundaries
    all_bounds = []
    for beam in beams:
        for _id, _n, bounds in _iter_beam_mlc_stacks(beam):
            all_bounds.append((bounds[0], bounds[-1]))
    all_bounds = np.array(all_bounds)
    y = np.arange(np.min(all_bounds), np.max(all_bounds) + resolution_mm, resolution_mm)
    x = np.arange(-width_mm / 2, width_mm / 2 + resolution_mm, resolution_mm)

    fluences = np.zeros((len(beams), len(y), len(x)), dtype=dtype)
    for beam_idx, beam in enumerate(beams):
        if str(getattr(beam, "TreatmentDeliveryType", "")) == "SETUP":
            continue
        cps = list(beam.ControlPointSequence)
        cumulative = 1000 * np.array([float(cp.CumulativeMetersetWeight) for cp in cps])
        mu_per_cp = torch.from_numpy(np.diff(cumulative, prepend=0).astype(np.float32)).to(device)

        stacks = _iter_beam_mlc_stacks(beam)
        stack_fluences = np.zeros((len(stacks), len(y), len(x)), dtype=dtype)
        for stack_idx, (mlc_id, n_pairs, boundaries) in enumerate(stacks):
            lefts, rights = _leaf_edges(cps, mlc_id, n_pairs)
            # to bins, as the reference counts a bin: x > left and x <= right
            left_edges = np.searchsorted(x, lefts.ravel(), side="right")
            right_edges = np.searchsorted(x, rights.ravel(), side="right")
            left_edges = np.clip(left_edges.reshape(n_pairs, len(cps)), 0, len(x))
            right_edges = np.clip(right_edges.reshape(n_pairs, len(cps)), 0, len(x))
            compact = interval_fluence(
                torch.from_numpy(left_edges.astype(np.int32)).to(device),
                torch.from_numpy(right_edges.astype(np.int32)).to(device),
                mu_per_cp, torch.zeros(n_pairs, dtype=torch.bool, device=device),
                len(x)).cpu().numpy()
            # the leaf rows onto the y grid
            row_to_leaf = np.argmax(np.asarray(boundaries)[:, None] - y[None, :] > 0, axis=0) - 1
            valid = row_to_leaf >= 0
            stack_fluences[stack_idx, valid, :] = compact[
                np.clip(row_to_leaf[valid], 0, n_pairs - 1)].astype(dtype)
        if len(stacks) == 1:
            fluences[beam_idx] = stack_fluences[0]
        elif len(stacks) > 1:
            # dual stacks (Halcyon): the aperture is the intersection
            fluences[beam_idx] = np.min(stack_fluences, axis=0)
    return fluences


def plot_fluences(plan, width_mm: float, resolution_mm: float, dtype=np.uint16,
                  show: bool = True, device=None) -> list:
    """One figure per beam."""
    import matplotlib.pyplot as plt

    fluences = generate_fluences(plan, width_mm, resolution_mm, dtype, device=device)
    figs = []
    for i, fluence in enumerate(fluences):
        fig, ax = plt.subplots()
        m = ax.imshow(fluence, aspect="auto")
        fig.colorbar(m)
        name = str(plan.BeamSequence[i].BeamName)
        ax.set_title(name)
        figs.append(fig)
    if show:
        plt.show()
    return figs
