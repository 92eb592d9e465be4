"""Seeded synthetic machine logs for :mod:`pylinac_tpu_torch.log_analyzer`.

The writers lay out the files as the readers expect them: a trajectory log
in the version 2.1 layout (a 1024-byte header, one subbeam, then per
snapshot the expected and actual value of 13 machine axes and of the MLC
axis's two carriages and 120 leaves, float32) and a dynalog A/B pair (six
header rows, then one CSV row per snapshot: MU, beam flags, gantry and
collimator in tenths of a degree, jaws in mm, then four columns a leaf,
positions in hundredths of a mm at the leaf plane). Neither package ships
clinical logs, so the tests and the smoke draw them here:

- :func:`write_vmat_tlog` and :func:`write_vmat_dynalog_pair`: one
  181-179 degree arc with a dose rate that swells and falls, a sliding
  window on every pair inside the Y jaws, actual positions one snapshot
  behind the expected ones plus seeded noise, and one beam hold;
- :func:`write_picket_tlog`: a picket fence delivery, the pairs' gaps parked
  at each picket while the beam is on, and held between pickets.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# Millennium 120: the pair centres (cm from the central axis), 10 outer
# pairs of 1 cm, 40 inner of 0.5 cm, 10 outer of 1 cm
_WIDTHS_CM = np.array([1.0] * 10 + [0.5] * 40 + [1.0] * 10)
PAIR_CENTERS_CM = np.cumsum(_WIDTHS_CM) - _WIDTHS_CM / 2 - 20.0
CM_TO_DYNALOG = 1000 / 1.96078  # cm at the isoplane to dynalog units
TLOG_INTERVAL_MS = 20

# the VMAT arc: total MU of the trajectory log, the leaves' seeded error
# (cm, one sigma), the symmetric Y and X jaws (cm from the axis)
VMAT_MU = 600.0
VMAT_ERROR_CM = 0.005
VMAT_JAW_Y_CM, VMAT_JAW_X_CM = 10.0, 7.0

# the picket fence: each pair's gap (mm), the snapshots parked at a picket
# with the beam on and moving between pickets held, MU a picket, the leaves'
# seeded error (cm), the jaws (cm)
PICKET_GAP_MM = 3.0
PICKET_DWELL, PICKET_TRANSIT = 50, 10
PICKET_MU = 10.0
PICKET_ERROR_CM = 0.002
PICKET_JAW_Y_CM, PICKET_JAW_X_CM = 15.0, 12.0


def _vmat_leaves(n_snap: int, rng):
    """(expected, actual) bank A and B positions, each (n_snap, 60) in cm:
    a sliding window on the pairs inside the Y jaws, the others closed."""
    t = np.arange(n_snap)[:, None] / n_snap
    p = np.arange(60)[None, :]
    centre = 3.0 * np.sin(2 * np.pi * t + 0.1 * p)
    half = 1.0 + 0.5 * np.sin(6 * np.pi * t + 0.05 * p)
    inside = (np.abs(PAIR_CENTERS_CM) < VMAT_JAW_Y_CM - 1.0)[None, :]
    exp_a = np.where(inside, centre + half, 0.0)
    exp_b = np.where(inside, half - centre, 0.0)

    def actual(expected):
        lag = np.concatenate([expected[:1], expected[:-1]])
        return lag + np.where(inside, rng.normal(0, VMAT_ERROR_CM, expected.shape), 0.0)

    return (exp_a, actual(exp_a)), (exp_b, actual(exp_b))


def _arc(n_snap: int, mu_total: float, hold: slice):
    """Gantry (deg), cumulative MU and beam-hold flags of a 181-179 arc."""
    s = np.arange(n_snap)
    gantry = (181.0 + 358.0 * s / max(n_snap - 1, 1)) % 360.0
    rate = 1.0 + 0.5 * np.sin(2 * np.pi * s / n_snap)
    hold_flag = np.zeros(n_snap)
    hold_flag[hold] = 1.0
    rate[hold] = 0.0
    mu = np.concatenate([[0.0], np.cumsum(rate[1:])])
    return gantry, mu / mu[-1] * mu_total, hold_flag


def _write_tlog(path, gantry, jaws_cm, mu, hold, leaves_a, leaves_b) -> str:
    """A version 2.1 trajectory log; every axis is (expected, actual)
    pairs of (n_snap,) arrays, the leaves (n_snap, 60) per bank."""
    n_snap = len(mu)
    num_leaves = 120
    num_axes = 14
    samples = [1] * 13 + [num_leaves + 2]
    cols = []

    def axis(expected, actual=None):
        cols.append(np.asarray(expected, np.float64) * np.ones(n_snap))
        cols.append(np.asarray(expected if actual is None else actual, np.float64)
                    * np.ones(n_snap))

    axis(0.0)                                       # collimator
    axis(*gantry)
    y1, y2, x1, x2 = jaws_cm
    for jaw in (y1, y2, x1, x2):
        axis(jaw)
    for _ in range(4):                              # couch vrt, lng, lat, rtn
        axis(0.0)
    axis(mu)
    axis(hold)
    axis(np.linspace(0, 177, n_snap))               # control point
    axis(0.0)                                       # carriages A and B
    axis(0.0)
    for (exp, act) in (leaves_a, leaves_b):
        for leaf in range(60):
            axis(exp[:, leaf], act[:, leaf])
    data = np.stack(cols, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(b"VOSTL".ljust(16, b"\x00"))
        f.write(b"2.1".ljust(16, b"\x00"))
        f.write(struct.pack("<3i", 1024, TLOG_INTERVAL_MS, num_axes))
        f.write(struct.pack(f"<{num_axes}i", *range(num_axes)))
        f.write(struct.pack(f"<{num_axes}i", *samples))
        # axis scale, subbeams, truncated, snapshots, MLC model (2: NDS 120)
        f.write(struct.pack("<5i", 1, 1, 0, n_snap, 2))
        f.write(b"\x00" * (1024 - (64 + num_axes * 8)))
        # the subbeam: control point, MU, radiation time, sequence, name
        f.write(struct.pack("<iffi", 0, float(mu[-1]), n_snap * TLOG_INTERVAL_MS / 1000, 1))
        f.write(b"arc1".ljust(32, b"\x00") + b"\x00" * 32)
        f.write(data.tobytes())
    return str(path)


def write_vmat_tlog(path, n_snap: int = 4000, seed: int = 0) -> str:
    """A VMAT arc as a trajectory log at 20 ms (4000 snapshots: 80 s)."""
    rng = np.random.default_rng(seed)
    gantry, mu, hold = _arc(n_snap, VMAT_MU, slice(n_snap // 4, n_snap // 4 + 10))
    leaves_a, leaves_b = _vmat_leaves(n_snap, rng)
    g_actual = gantry + rng.normal(0, 0.05, n_snap)
    jaws = (VMAT_JAW_Y_CM, VMAT_JAW_Y_CM, VMAT_JAW_X_CM, VMAT_JAW_X_CM)
    return _write_tlog(path, (gantry, g_actual), jaws, mu, hold, leaves_a, leaves_b)


def write_picket_tlog(path, pickets_mm, seed: int = 0) -> str:
    """A picket fence delivery: each pair's :data:`PICKET_GAP_MM` gap parked
    at each picket position (mm at the isoplane) for :data:`PICKET_DWELL`
    snapshots with the beam on, moving between pickets for
    :data:`PICKET_TRANSIT` snapshots held."""
    rng = np.random.default_rng(seed)
    centres, holds, mus = [], [], []
    mu = 0.0
    for k, x in enumerate(pickets_mm):
        if k:
            prev = pickets_mm[k - 1]
            centres += list(np.linspace(prev, x, PICKET_TRANSIT + 2)[1:-1] / 10)
            holds += [1.0] * PICKET_TRANSIT
            mus += [mu] * PICKET_TRANSIT
        for _ in range(PICKET_DWELL):
            mu += PICKET_MU / PICKET_DWELL
            centres.append(x / 10)
            holds.append(0.0)
            mus.append(mu)
    n_snap = len(centres)
    c = np.asarray(centres)[:, None] * np.ones((1, 60))
    half = PICKET_GAP_MM / 20
    exp_a, exp_b = c + half, half - c
    leaves = [(e, e + rng.normal(0, PICKET_ERROR_CM, e.shape)) for e in (exp_a, exp_b)]
    gantry = np.zeros(n_snap)
    jaws = (PICKET_JAW_Y_CM, PICKET_JAW_Y_CM, PICKET_JAW_X_CM, PICKET_JAW_X_CM)
    return _write_tlog(path, (gantry, gantry), jaws, np.asarray(mus), np.asarray(holds),
                       *leaves)


def write_vmat_dynalog_pair(directory, n_snap: int = 1600, seed: int = 0,
                            name: str = "12345_arc") -> dict:
    """The VMAT arc as a dynalog pair at 50 ms (1600 snapshots: 80 s); the
    MU column runs to 25000, the dynalog's own scale. Returns the A and B
    paths."""
    rng = np.random.default_rng(seed)
    gantry, mu, hold = _arc(n_snap, 25000.0, slice(n_snap // 4, n_snap // 4 + 4))
    banks = dict(zip("AB", _vmat_leaves(n_snap, rng)))
    header = [["B"], ["Patient Name", name.split("_")[0]], ["plan.dcm"], ["2"], ["60"], ["1"]]
    paths = {}
    for bank in "AB":
        rows = np.zeros((n_snap, 14 + 60 * 4))
        rows[:, 0] = mu
        rows[:, 2] = hold
        rows[:, 3] = 1.0
        rows[:, 6] = gantry * 10
        rows[:, 8] = rows[:, 9] = VMAT_JAW_Y_CM * 10
        rows[:, 10] = rows[:, 11] = VMAT_JAW_X_CM * 10
        expected, actual = banks[bank]
        rows[:, 14::4] = expected * CM_TO_DYNALOG
        rows[:, 15::4] = actual * CM_TO_DYNALOG
        path = str(Path(directory) / f"{bank}{name}.dlg")
        with open(path, "w", encoding="utf-8") as f:
            for line in header:
                f.write(",".join(line) + "\n")
            np.savetxt(f, rows, fmt="%.1f", delimiter=",")
        paths[bank] = path
    return paths
