"""Jaw orthogonality from the angles of the field's four edges.

Port of ``pylinac_tpu/contrib/orthogonality.py`` (``JawOrthogonality``
``:19``, ``analyze`` ``:25-68``). ``stretch`` runs on the host;
:func:`..ops.edges.canny` runs on ``analyze``'s device, its hysteresis
labelled by ``csrc/ccl.cu`` on the card; the Hough transform over 3600
angles and its peaks run on the host (``planar_imaging.hough_line``, one
``bincount``). ``plot_analyzed_image`` (``:72``) is JAX's and imports
matplotlib inside.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..core.array_utils import stretch
from ..core.image import load
from ..core.utilities import resolve_device
from ..ops.edges import canny
from ..planar_imaging import hough_line, hough_line_peaks


class JawOrthogonality:
    """Angles between the 4 jaw edges of a (nominally square) field."""

    def __init__(self, path: str | Path):
        self.image = load(path)

    def analyze(self, device=None):
        """The edges on ``device`` (``None`` means CUDA), the lines and
        angles on the host."""
        device = resolve_device(device, type(self).__name__)
        edge_image = stretch(self.image.array)
        edge_image = canny(torch.from_numpy(np.asarray(edge_image, np.float32)).to(device))
        self.edge_image = edge_image = edge_image.cpu().numpy()

        # 0.05 degree precision over the half circle
        tested_angles = np.linspace(-np.pi / 2, np.pi / 2, num=360 * 10, endpoint=False)
        h, theta, d = hough_line(edge_image, theta=tested_angles)
        self.hspace = h
        hspace, angles, dists = hough_line_peaks(h, theta, d, num_peaks=4)
        sorted_angles_idx = np.argsort(np.abs(angles))
        sorted_angles = angles[sorted_angles_idx]
        sorted_dists = dists[sorted_angles_idx]
        # the first two are the horizontal-ish lines, the last two the
        # vertical-ish; the lower distance is the top or the left
        line_angles = {}
        if sorted_dists[0] < sorted_dists[1]:
            line_angles["left"] = {"angle": sorted_angles[0], "dist": sorted_dists[0]}
            line_angles["right"] = {"angle": sorted_angles[1], "dist": sorted_dists[1]}
        else:
            line_angles["left"] = {"angle": sorted_angles[1], "dist": sorted_dists[1]}
            line_angles["right"] = {"angle": sorted_angles[0], "dist": sorted_dists[0]}
        if sorted_dists[2] < sorted_dists[3]:
            line_angles["bottom"] = {"angle": sorted_angles[2], "dist": sorted_dists[2]}
            line_angles["top"] = {"angle": sorted_angles[3], "dist": sorted_dists[3]}
        else:
            line_angles["bottom"] = {"angle": sorted_angles[3], "dist": sorted_dists[3]}
            line_angles["top"] = {"angle": sorted_angles[2], "dist": sorted_dists[2]}

        result = {
            "top_left": abs(np.rad2deg(line_angles["left"]["angle"]
                                       - line_angles["top"]["angle"])),
            "top_right": abs(np.rad2deg(line_angles["right"]["angle"]
                                        - line_angles["top"]["angle"])),
            "bottom_left": abs(np.rad2deg(line_angles["left"]["angle"]
                                          - line_angles["bottom"]["angle"])),
            "bottom_right": abs(np.rad2deg(line_angles["right"]["angle"]
                                           - line_angles["bottom"]["angle"])),
        }
        self.line_angles = line_angles
        self.result = result

    def results(self) -> dict[str, float]:
        """Keys: 'top_left', 'top_right', 'bottom_left', 'bottom_right' (deg)."""
        return self.result

    def plot_analyzed_image(self, show: bool = True):
        import matplotlib.pyplot as plt

        colors = ["r", "b", "c", "m"]
        fig, axes = plt.subplots()
        axes.imshow(self.image.array, cmap="gray")
        for idx, (key, data) in enumerate(self.line_angles.items()):
            (x0, y0) = data["dist"] * np.array(
                [np.cos(data["angle"]), np.sin(data["angle"])])
            axes.axline((x0, y0), slope=np.tan(data["angle"] + np.pi / 2),
                        label=key, color=colors[idx])
        axes.set_title("Jaw Orthogonality")
        axes.set_axis_off()
        axes.legend()
        if show:
            plt.show()
