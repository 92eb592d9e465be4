"""Synthetic ACR MRI Large series, numpy only.

Port of ``generate_acr_mri`` (``pylinac_tpu/imggen/mri.py:32``), unchanged
apart from the DICOM codec (the port's ``core/dcm.py``) and the module it
reads the low-contrast spokes from (the port's :mod:`pylinac_tpu_torch.acr`).
The same seed gives the same pixels as the JAX package's generator:

11 axial slices at 10mm spacing (slice 1 at z=0) + one sagittal localizer:

* slice 1: roll hole at -135deg, position bars, crossed thickness ramps,
  resolution grids;
* slice 5 (z=40): plain disk (geometric distortion);
* slice 7 (z=60): plain disk (uniformity; ghost ROIs sample outside);
* slices 8-11 (z=70..100): low-contrast ring + spokes;
* slice 11 (z=100): position bars.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..core import dcm

BODY = 1000.0
BG = 20.0


def _disk(arr, cx, cy, r_px, value):
    h, w = arr.shape
    yy, xx = np.mgrid[:h, :w]
    arr[(yy - cy) ** 2 + (xx - cx) ** 2 < r_px**2] = value


def generate_acr_mri(
    dir_out: str | Path,
    mm_per_pixel: float = 0.5,
    image_size: int = 512,
    phantom_radius_mm: float = 100,
    slice_spacing_mm: float = 10.0,
    lc_visible_spokes: int = 4,
    lc_contrast: float = 80.0,
    include_sagittal: bool = True,
    noise: float = 2.0,
    seed: int = 5,
) -> list[str]:
    from ..acr import MRLowContrastModule

    rng = np.random.default_rng(seed)
    os.makedirs(dir_out, exist_ok=True)
    center = image_size / 2 - 0.5
    r_phan_px = phantom_radius_mm / mm_per_pixel
    series_uid = dcm.generate_uid()
    study_uid = dcm.generate_uid()
    frame_uid = dcm.generate_uid()
    paths = []
    yy, xx = np.mgrid[:image_size, :image_size]
    in_phantom = (yy - center) ** 2 + (xx - center) ** 2 < r_phan_px**2

    def mm(v):
        return v / mm_per_pixel

    def write(arr, z, i, orientation, name):
        stored = np.clip(arr, 0, 65535).astype(np.uint16)
        ds = dcm.Dataset()
        ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.4"
        ds.SOPInstanceUID = dcm.generate_uid()
        ds.StudyInstanceUID = study_uid
        ds.SeriesInstanceUID = series_uid
        ds.FrameOfReferenceUID = frame_uid
        ds.Modality = "MR"
        ds.PatientName = "ACRMRI^Synthetic"
        ds.PatientID = "ACRMRI"
        ds.PixelSpacing = [mm_per_pixel, mm_per_pixel]
        ds.SliceThickness = slice_spacing_mm
        ds.MagneticFieldStrength = 1.5
        ds.EchoNumbers = 1
        ds.ImageOrientationPatient = list(orientation)
        ds.ImagePositionPatient = [0.0, 0.0, float(z)]
        ds.InstanceNumber = i + 1
        ds.set_pixel_data(stored)
        path = str(Path(dir_out) / name)
        dcm.dcmwrite(path, ds)
        paths.append(path)

    for i in range(11):
        z = i * slice_spacing_mm
        arr = np.full((image_size, image_size), BG)
        arr[in_phantom] = BODY

        if i == 0:  # slice 1
            # roll hole (20mm radius) at -135deg, 65mm out
            a = np.deg2rad(-135)
            _disk(arr, center + np.cos(a) * mm(65), center + np.sin(a) * mm(65),
                  mm(20), BG)
            # position bars: bright 1500 bars near the top at x=+/-2.8mm-ish;
            # symmetric -> zero shift. Bars start 55mm above center and run
            # 15mm down.
            for ang in (2.5, -2.5):
                aa = np.deg2rad(-90 + ang)
                bx = center + np.cos(aa) * mm(65)
                top_rows = slice(int(center - mm(62)), int(center - mm(47)))
                arr[top_rows, int(bx - mm(1)):int(bx + mm(1))] = 1500
            # crossed thickness ramps: two 50mm bright segments at center
            for dist in (-3, 2.5):
                cy = center + mm(dist)
                arr[int(cy - mm(1)):int(cy + mm(1)),
                    int(center - mm(25)):int(center + mm(25))] = 1500
            # resolution grids: checkered disks with declining amplitude.
            # The 0.9-1.1 mm hole grids are at/beyond Nyquist for 0.5 mm
            # pixels, so true-frequency rasterization is impossible —
            # instead the modulation amplitude emulates the scanner's MTF.
            # The michelson rMTF measured by MRSlice1Module is amp/BODY
            # relative to the reference disk, so these amplitudes place the
            # curve at (1.0, 0.75, 0.45, 0.06): the 10% point falls inside
            # the measured 0-1.11 lp/mm range and relative_resolution(10..90)
            # interpolates instead of warning about extrapolation.
            res_settings = [("Row Reference", 9, 58, 135, 400),
                            ("Col Reference", 9, 58, 135, 400),
                            ("Row 1.1", 3, 40, 116, 300),
                            ("Col 1.1", 3, 44, 104, 300),
                            ("Row 1.0", 3, 36, 81, 180),
                            ("Col 1.0", 3, 44, 74, 180),
                            ("Row 0.9", 2, 46, 52, 24),
                            ("Col 0.9", 2, 55, 51, 24)]
            for _name, radius, dist, angle, amp in res_settings:
                aa = np.deg2rad(angle)
                px = center + np.cos(aa) * mm(dist)
                py = center + np.sin(aa) * mm(dist)
                mask = (yy - py) ** 2 + (xx - px) ** 2 <= mm(radius) ** 2
                stripes = np.where((xx // 2) % 2 == 0, BODY + amp, BODY - amp)
                arr[mask] = stripes[mask]
        if i == 10:  # slice 11 position bars
            for ang in (2.5, -2.5):
                aa = np.deg2rad(-90 + ang)
                bx = center + np.cos(aa) * mm(65)
                top_rows = slice(int(center - mm(62)), int(center - mm(47)))
                arr[top_rows, int(bx - mm(1)):int(bx + mm(1))] = 1500
        if 7 <= i <= 10:  # low-contrast slices 8..11
            start_angle = (i - 7) * 9
            # LC region ring at 40mm
            rr = np.sqrt((yy - center) ** 2 + (xx - center) ** 2)
            ring = (rr > mm(40)) & (rr < mm(42))
            arr[ring] = BODY - 400
            for s_idx, (name, setting) in enumerate(
                    MRLowContrastModule.roi_settings.items()):
                if s_idx >= lc_visible_spokes:
                    break
                for dist in setting["distances"]:
                    aa = np.deg2rad(setting["angle"] + start_angle)
                    px = center + np.cos(aa) * mm(dist)
                    py = center + np.sin(aa) * mm(dist)
                    _disk(arr, px, py, max(mm(setting["radius"]), 2),
                          BODY + lc_contrast)

        arr += rng.normal(0, noise, arr.shape)
        write(arr, z, i, (1, 0, 0, 0, 1, 0), f"mr_{i:03d}.dcm")

    if include_sagittal:
        arr = np.full((image_size, image_size), BG)
        # rectangle: phantom length 148mm (z) x 190mm wide
        arr[int(center - mm(74)):int(center + mm(74)),
            int(center - mm(95)):int(center + mm(95))] = BODY
        arr += rng.normal(0, noise, arr.shape)
        write(arr, -100.0, 11, (0, 1, 0, 0, 0, -1), "mr_sag.dcm")
    return paths
