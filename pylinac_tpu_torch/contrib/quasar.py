"""Quasar light/rad and scaling analysis.

Port of ``pylinac_tpu/contrib/quasar.py`` (``QuasarLightRadScaling``
``:12``): a ``StandardImagingFC2`` whose BBs sit inside the detected field
edges (``_determine_bb_set`` ``:28-39``) and whose five central scaling BBs
come from one ``SizedDiskLocator`` (``:41-48``). Everything runs on
``analyze``'s device, as FC-2's does: the frame's medians on
``csrc/median3x3.cu``, each BB window's regions on ``csrc/ccl.cu``.
"""

from __future__ import annotations

from ..core.geometry import Point
from ..metrics.image import SizedDiskLocator
from ..planar_imaging import StandardImagingFC2


class QuasarLightRadScaling(StandardImagingFC2):
    """Light/rad and scaling for the Quasar phantom: BBs offset from the
    field edges for the CAX and 5 central BBs for scaling."""

    common_name = "Quasar Light/Rad Scaling"
    bb_sampling_box_size_mm = 10
    bb_size_mm = 5
    field_strip_width_mm = 20
    light_rad_bb_offset_mm = 11

    def analyze(self, invert: bool = False, fwxm: int = 50,
                bb_edge_threshold_mm: float = 10, device=None) -> None:
        """FC-2's analysis, then the scaling BBs, on ``device`` (``None``
        means CUDA)."""
        super().analyze(invert=invert, fwxm=fwxm,
                        bb_edge_threshold_mm=bb_edge_threshold_mm, device=device)
        self.scaling_centers = self._detect_scaling_centers()

    def _determine_bb_set(self, fwxm: int) -> dict:
        """BBs offset inward from the detected field edges."""
        fs_y = self.field_width_y / 2
        fs_x = self.field_width_x / 2
        off = self.light_rad_bb_offset_mm
        return {
            "TL": (-fs_x + off, -fs_y + off),
            "BL": (-fs_x + off, fs_y - off),
            "TR": (fs_x - off, fs_y - off),
            "BR": (fs_x - off, -fs_y + off),
        }

    def _detect_scaling_centers(self) -> list[Point]:
        """The 5 central scaling BBs."""
        return self.image.compute(
            SizedDiskLocator.from_center_physical(
                expected_position_mm=Point(0, 0),
                search_window_mm=(35, 35),
                radius_mm=self.bb_size_mm / 2,
                radius_tolerance_mm=self.bb_size_mm / 2,
                min_number=5, max_number=5, min_separation_mm=4, device=self.device))
