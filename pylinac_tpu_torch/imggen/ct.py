"""Synthetic CatPhan 504, Quart DVT, TomoCheese, ACR CT and GE Helios CT
stacks, numpy only.

Port of ``generate_catphan504`` (``pylinac_tpu/imggen/ct.py:56-222``),
``generate_quart`` (``:238-320``), ``generate_tomocheese`` (``:322``),
``generate_acr_ct`` (``:402``) and ``generate_helios`` (``:489``) with their
helpers, unchanged apart from the DICOM codec (the port's ``core/dcm.py``):
a DICOM CT series emulating a CatPhan 504, a 20 cm water cylinder with the
CTP404 (HU plugs, air bubbles, wire ramps, geometry nodes), CTP486
(uniformity), CTP528 (line-pair gauge) and CTP515 (low-contrast bubbles)
modules at their nominal z-offsets; a Quart DVT, a 16 cm acrylic cylinder
with its HU inserts, water vial and slice-thickness air wedges; a
TomoCheese with its 20 plugs; an ACR CT 464 with its four modules; and a
GE Helios with its Section 1 and uniform Section 3. The same seed gives the
same pixels as the JAX package's generators.

Two private generators, test and smoke data with no JAX counterpart (the
JAX package generates neither), write a CatPhan 503, 600, 604 or 700 series
(:func:`_generate_catphan`, :func:`_generate_catphan700`) and a kV CBCT of a BB
(:func:`_generate_cbct_bb`, the fixture of
``tests/models/test_winstonlutz.py:124-157`` at any size), in any transfer
syntax the port's ``dcmwrite`` encodes.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..core import dcm

# CatPhan 504 module z-offsets (mm)
CTP404_OFFSET = 0
CTP486_OFFSET = -65
CTP528_OFFSET = 30
CTP515_OFFSET = -30

HU_PLUGS = {  # angle (deg, y-down image convention), HU
    "Air": (-90, -1000),
    "PMP": (-120, -196),
    "LDPE": (180, -104),
    "Poly": (120, -47),
    "Acrylic": (60, 115),
    "Delrin": (0, 365),
    "Teflon": (-60, 1000),
}
PLUG_DIST_MM = 58.7
PLUG_RADIUS_MM = 6.0


def _smooth(arr: np.ndarray) -> np.ndarray:
    """Cheap separable 3-tap blur (band-limits the synthetic noise)."""
    k = np.array([0.25, 0.5, 0.25])
    out = arr
    for ax in (0, 1):
        out = (np.take(out, np.r_[0, np.arange(out.shape[ax] - 1)], axis=ax) * k[0]
               + out * k[1]
               + np.take(out, np.r_[np.arange(1, out.shape[ax]), out.shape[ax] - 1], axis=ax) * k[2])
    return out


def _disk(arr, cx, cy, r_px, value):
    h, w = arr.shape
    yy, xx = np.mgrid[:h, :w]
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r_px**2
    arr[mask] = value


CP504_GAUGE_BOUNDARIES = (0, 0.107, 0.173, 0.236, 0.286, 0.335, 0.387, 0.434, 0.479)


def _draw_gauge(hu: np.ndarray, yy: np.ndarray, xx: np.ndarray, center: float,
                mm_per_pixel: float, roll: float, start_angle: float = np.pi,
                ccw: bool = True,
                boundaries: tuple = CP504_GAUGE_BOUNDARIES) -> np.ndarray:
    """``hu`` with the CTP528 line-pair gauge drawn at r = 47 mm, its eight
    regions between ``boundaries`` (fractions of the circle) along the
    circle profile that starts at ``start_angle`` + ``roll`` (radians,
    y-down) and runs counter-clockwise if ``ccw``, as the analyzer's
    ``CollapsedCircleProfile`` samples it; then blurred once."""
    r_gauge = 47.0
    npeaks = (2, 3, 4, 4, 4, 5, 5, 5)
    # nominal gap size (cm) per region — the physical bar width of
    # the real gauge (region N is N lp/cm, so gap = 5/N mm).  Bars
    # are drawn at this TRUE width, centered in the analyzer's
    # angular sector (analyzer table: ct.py CTP528CP504.roi_settings,
    # reference ct.py:1398).  Stretching `npeaks` bars across the
    # whole sector instead rasterizes region 8 at ~3.8 lp/cm — the
    # measured MTF floor then never reaches 10-30% and every
    # results_data() call warns about extrapolation.
    gaps_cm = (0.5, 0.25, 0.167, 0.125, 0.1, 0.083, 0.071, 0.063)
    circ = 2 * np.pi * r_gauge  # mm of arc along the gauge ring
    # anti-aliased bar coverage via 2x2 subpixel supersampling —
    # hard boolean bars rasterize to ±1 px width jitter between
    # regions, which wobbles the measured peak/valley means enough
    # to make the MTF non-monotonic on an otherwise clean phantom
    cov = np.zeros_like(hu)
    band_any = np.zeros(hu.shape, bool)
    for oy in (-0.25, 0.25):
        for ox in (-0.25, 0.25):
            ys, xs = yy + oy, xx + ox
            rr = np.hypot(ys - center, xs - center) * mm_per_pixel
            band = (rr > r_gauge - 3) & (rr < r_gauge + 3)
            band_any |= band
            theta = np.arctan2(ys - center, xs - center) - roll
            if ccw:
                f = ((start_angle - theta) % (2 * np.pi)) / (2 * np.pi)
            else:
                f = ((theta - start_angle) % (2 * np.pi)) / (2 * np.pi)
            for region in range(8):
                f0, f1 = boundaries[region], boundaries[region + 1]
                n = npeaks[region]
                sector_mm = (f1 - f0) * circ
                bar_mm = gaps_cm[region] * 10.0
                period_mm = 2.0 * bar_mm
                train_mm = (n - 1) * period_mm + bar_mm
                off_mm = (sector_mm - train_mm) / 2.0
                in_region = band & (f >= f0) & (f < f1)
                s = (f - f0) * circ  # arc-length into the sector
                phase = s - off_mm
                bars = in_region & (phase >= 0) & (phase < train_mm) & (
                    phase % period_mm < bar_mm)
                cov[bars] += 0.25
    hu = np.where(band_any, hu * (1 - cov) + 800.0 * cov, hu)
    # finite scanner resolution: one binomial pass on top of the
    # supersampled rasterization gives MTF50 ≈ 0.49 lp/mm (reference
    # demo: ~0.56) with the 10% point ≈ 0.77 lp/mm — inside the
    # 0.1-0.8 lp/mm gauge range, so relative_resolution(10..90)
    # interpolates instead of warning about extrapolation, while
    # region 8 keeps ~7% true modulation for the peak finder.
    hu = _smooth(hu)
    return hu


def generate_catphan504(
    dir_out: str | Path,
    num_slices: int = 60,
    slice_thickness_mm: float = 2.5,
    mm_per_pixel: float = 0.5,
    image_size: int = 512,
    phantom_radius_mm: float = 101,
    roll_deg: float = 0.0,
    noise_hu: float = 3.0,
    low_contrast_hu: float = 10.0,
    seed: int = 1234,
) -> list[str]:
    """Write a synthetic CatPhan 504 series; returns the file paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(dir_out, exist_ok=True)
    center = image_size / 2 - 0.5
    r_phan_px = phantom_radius_mm / mm_per_pixel
    series_uid = dcm.generate_uid()
    study_uid = dcm.generate_uid()
    frame_uid = dcm.generate_uid()
    paths = []
    z_positions = (np.arange(num_slices) - num_slices / 2) * slice_thickness_mm
    roll = np.deg2rad(roll_deg)

    yy, xx = np.mgrid[:image_size, :image_size]
    in_phantom = (yy - center) ** 2 + (xx - center) ** 2 < r_phan_px**2

    def polar_to_px(angle_deg, dist_mm):
        a = np.deg2rad(angle_deg) + roll
        return (center + np.cos(a) * dist_mm / mm_per_pixel,
                center + np.sin(a) * dist_mm / mm_per_pixel)

    for i, z in enumerate(z_positions):
        hu = np.full((image_size, image_size), -1000.0)  # air outside
        hu[in_phantom] = 0.0  # water body

        # --- CTP404 (HU plugs + ramps + air bubbles + geometry nodes)
        if abs(z - CTP404_OFFSET) <= 20:
            # module body: epoxy-like disk (real CatPhan modules are ~+50 HU);
            # also keeps the geometry-node clip bound away from the noise floor
            body = (yy - center) ** 2 + (xx - center) ** 2 < (95 / mm_per_pixel) ** 2
            hu[body] = 45.0
            for _name, (angle, value) in HU_PLUGS.items():
                px, py = polar_to_px(angle, PLUG_DIST_MM)
                _disk(hu, px, py, PLUG_RADIUS_MM / mm_per_pixel, value)
            # air bubbles above/below center (for roll detection) — outside
            # the 35mm geometry box but clear of the 58.7mm plug ring
            for bub_angle in (-90, 90):
                px, py = polar_to_px(bub_angle, 44)
                _disk(hu, px, py, 6.0 / mm_per_pixel, -1000)
        if abs(z - CTP404_OFFSET) <= slice_thickness_mm * 1.6:
            # wire ramps at ±38mm: 23° ramps. On slice z the wire's bright
            # in-plane segment has length T/0.42 and its center shifts along
            # the ramp axis by z/0.42 — so combining neighboring slices
            # lengthens the apparent wire exactly like the real phantom.
            # half-open pixel intervals so neighboring slices tile the wire
            # without double-covering any pixel
            lo_px = (z - CTP404_OFFSET - slice_thickness_mm / 2) / (0.42 * mm_per_pixel)
            hi_px = (z - CTP404_OFFSET + slice_thickness_mm / 2) / (0.42 * mm_per_pixel)
            for angle, horiz in ((180, False), (0, False), (90, True), (-90, True)):
                px, py = polar_to_px(angle, 38)
                t = max(int(round(0.4 / mm_per_pixel)), 1)
                lo = int(round(px + lo_px)) if horiz else int(round(py + lo_px))
                hi = int(round(px + hi_px)) if horiz else int(round(py + hi_px))
                if horiz:
                    hu[int(py) - t: int(py) + t + 1, lo:hi] = 800
                else:
                    hu[lo:hi, int(px) - t: int(px) + t + 1] = 800
            # small central air hole (real modules have one; it also anchors
            # the reference's geometry clip bound away from the noise floor)
            _disk(hu, center, center, 1.2 / mm_per_pixel, -1000)
            # geometry nodes: 4 wire dots 50mm apart centered on phantom
            for dx, dy in ((-25, -25), (25, -25), (-25, 25), (25, 25)):
                a = np.array([dx, dy]) / mm_per_pixel
                c, s = np.cos(roll), np.sin(roll)
                gx = center + a[0] * c - a[1] * s
                gy = center + a[0] * s + a[1] * c
                _disk(hu, gx, gy, 2.5 / mm_per_pixel, 900)

        # --- CTP528 (line pair gauge at r=47mm)
        if abs(z - CTP528_OFFSET) <= 20:
            hu = _draw_gauge(hu, yy, xx, center, mm_per_pixel, roll)

        # --- CTP515 (low contrast bubbles)
        if abs(z - CTP515_OFFSET) <= 8:
            for angle, radius_mm in zip((-87.4, -69.1, -52.7, -38.5, -25.1, -12.9),
                                        (6, 3.5, 3, 2.5, 2, 1.5)):
                px, py = polar_to_px(angle, 50)
                _disk(hu, px, py, radius_mm / mm_per_pixel, low_contrast_hu)

        # band-limited noise like a real reconstruction (white noise would
        # put unrealistic energy at the highest frequencies). Three blur
        # passes ≈ 2-3 px correlation length, typical of CT kernels.
        noise = rng.normal(0, noise_hu, hu.shape)
        noise = _smooth(_smooth(_smooth(noise)))
        noise *= noise_hu / max(noise.std(), 1e-9)
        hu += noise

        stored = np.clip(hu + 1000, 0, 65535).astype(np.uint16)
        ds = dcm.Dataset()
        ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
        ds.SOPInstanceUID = dcm.generate_uid()
        ds.StudyInstanceUID = study_uid
        ds.SeriesInstanceUID = series_uid
        ds.FrameOfReferenceUID = frame_uid
        ds.Modality = "CT"
        ds.PatientName = "CatPhan^Synthetic"
        ds.PatientID = "CTP504"
        ds.PixelSpacing = [mm_per_pixel, mm_per_pixel]
        ds.SliceThickness = slice_thickness_mm
        ds.RescaleSlope = 1.0
        ds.RescaleIntercept = -1000.0
        ds.ImagePositionPatient = [0.0, 0.0, float(z)]
        ds.InstanceNumber = i + 1
        ds.set_pixel_data(stored)
        path = str(Path(dir_out) / f"ct_{i:03d}.dcm")
        dcm.dcmwrite(path, ds)
        paths.append(path)
    return paths


# Quart DVT geometry (``pylinac_tpu_torch/quart.py``)
QUART_UNIFORMITY_OFFSET = -45
QUART_GEOMETRY_OFFSET = 45
QUART_HU_PLUGS = {  # angle (deg, y-down), HU, radius mm
    "Air": (-90, -1000, 8.0),
    "Poly": (0, -35, 8.0),
    "Acrylic": (45, 120, 8.0),
    "Teflon": (180, 990, 8.0),
    "Water": (-45, 0, 12.0),
}
QUART_PLUG_DIST_MM = 52.5


def generate_quart(
    dir_out: str | Path,
    num_slices: int = 60,
    slice_thickness_mm: float = 2.5,
    mm_per_pixel: float = 0.5,
    image_size: int = 512,
    phantom_radius_mm: float = 80,
    roll_deg: float = 0.0,
    noise_hu: float = 3.0,
    seed: int = 1234,
) -> list[str]:
    """Write a synthetic Quart DVT series (acrylic body, HU inserts,
    thickness air wedges); returns the file paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(dir_out, exist_ok=True)
    center = image_size / 2 - 0.5
    r_phan_px = phantom_radius_mm / mm_per_pixel
    series_uid = dcm.generate_uid()
    study_uid = dcm.generate_uid()
    frame_uid = dcm.generate_uid()
    paths = []
    z_positions = (np.arange(num_slices) - num_slices / 2) * slice_thickness_mm
    roll = np.deg2rad(roll_deg)

    yy, xx = np.mgrid[:image_size, :image_size]
    in_phantom = (yy - center) ** 2 + (xx - center) ** 2 < r_phan_px**2

    def polar_to_px(angle_deg, dist_mm):
        a = np.deg2rad(angle_deg) + roll
        return (center + np.cos(a) * dist_mm / mm_per_pixel,
                center + np.sin(a) * dist_mm / mm_per_pixel)

    for i, z in enumerate(z_positions):
        hu = np.full((image_size, image_size), -1000.0)
        hu[in_phantom] = 120.0  # acrylic body

        if abs(z) <= 14:  # HU module
            for _name, (angle, value, radius) in QUART_HU_PLUGS.items():
                px, py = polar_to_px(angle, QUART_PLUG_DIST_MM)
                _disk(hu, px, py, radius / mm_per_pixel, value)
            # an extra air insert at +90 (bottom, vertical axis): with the
            # Air insert at -90 it anchors the roll detection
            px, py = polar_to_px(90, QUART_PLUG_DIST_MM)
            _disk(hu, px, py, 8.0 / mm_per_pixel, -1000)
        if abs(z) <= slice_thickness_mm * 1.6:
            # thickness air wedges at +-32 mm, inclined 30 degrees: the dark
            # in-plane segment moves along x by z / 0.577
            lo_px = (z - slice_thickness_mm / 2) / (0.577 * mm_per_pixel)
            hi_px = (z + slice_thickness_mm / 2) / (0.577 * mm_per_pixel)
            t = max(int(round(1.0 / mm_per_pixel)), 1)
            for angle in (90, -90):
                px, py = polar_to_px(angle, 32)
                lo = int(round(px + lo_px))
                hi = int(round(px + hi_px))
                hu[int(py) - t: int(py) + t + 1, lo:hi] = -1000

        noise = rng.standard_normal((image_size, image_size))
        noise = _smooth(_smooth(_smooth(noise)))
        noise *= noise_hu / max(noise.std(), 1e-9)
        hu += noise

        stored = np.clip(hu + 1000, 0, 65535).astype(np.uint16)
        ds = dcm.Dataset()
        ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
        ds.SOPInstanceUID = dcm.generate_uid()
        ds.StudyInstanceUID = study_uid
        ds.SeriesInstanceUID = series_uid
        ds.FrameOfReferenceUID = frame_uid
        ds.Modality = "CT"
        ds.PatientName = "Quart^Synthetic"
        ds.PatientID = "QUARTDVT"
        ds.PixelSpacing = [mm_per_pixel, mm_per_pixel]
        ds.SliceThickness = slice_thickness_mm
        ds.RescaleSlope = 1.0
        ds.RescaleIntercept = -1000.0
        ds.ImagePositionPatient = [0.0, 0.0, float(z)]
        ds.InstanceNumber = i + 1
        ds.set_pixel_data(stored)
        path = str(Path(dir_out) / f"quart_{i:03d}.dcm")
        dcm.dcmwrite(path, ds)
        paths.append(path)
    return paths


def generate_tomocheese(
    dir_out: str | Path,
    num_slices: int = 24,
    slice_thickness_mm: float = 2.5,
    mm_per_pixel: float = 0.8,
    image_size: int = 512,
    phantom_radius_mm: float = 150,
    roll_deg: float = 0.0,
    plug_hus: dict[str, float] | None = None,
    noise_hu: float = 3.0,
    seed: int = 7,
) -> list[str]:
    """Write a synthetic TomoCheese series: solid-water cylinder with the 20
    plug layout of ``pylinac_tpu_torch.cheese.TomoCheeseModule``."""
    from ..cheese import TomoCheeseModule

    if plug_hus is None:
        # include a strong low and high plug on the outer ring so both the
        # origin-slice finder and the roll finder have signal
        plug_hus = {name: 0.0 for name in TomoCheeseModule.roi_settings}
        plug_hus.update({"1": -800, "6": 800, "8": 300, "13": -300,
                         "2": 50, "9": -50})
    rng = np.random.default_rng(seed)
    os.makedirs(dir_out, exist_ok=True)
    center = image_size / 2 - 0.5
    r_phan_px = phantom_radius_mm / mm_per_pixel
    series_uid = dcm.generate_uid()
    study_uid = dcm.generate_uid()
    frame_uid = dcm.generate_uid()
    paths = []
    z_positions = (np.arange(num_slices) - num_slices / 2) * slice_thickness_mm
    roll = np.deg2rad(roll_deg)
    yy, xx = np.mgrid[:image_size, :image_size]
    in_phantom = (yy - center) ** 2 + (xx - center) ** 2 < r_phan_px**2

    for i, z in enumerate(z_positions):
        hu = np.full((image_size, image_size), -1000.0)
        hu[in_phantom] = 0.0  # solid water body
        for name, setting in TomoCheeseModule.roi_settings.items():
            a = np.deg2rad(setting["angle"]) + roll
            px = center + np.cos(a) * setting["distance"] / mm_per_pixel
            py = center + np.sin(a) * setting["distance"] / mm_per_pixel
            _disk(hu, px, py, setting["radius"] / mm_per_pixel,
                  plug_hus[name])
        noise = rng.standard_normal((image_size, image_size))
        noise = _smooth(_smooth(_smooth(noise)))
        noise *= noise_hu / max(noise.std(), 1e-9)
        hu += noise
        stored = np.clip(hu + 1000, 0, 65535).astype(np.uint16)
        ds = dcm.Dataset()
        ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
        ds.SOPInstanceUID = dcm.generate_uid()
        ds.StudyInstanceUID = study_uid
        ds.SeriesInstanceUID = series_uid
        ds.FrameOfReferenceUID = frame_uid
        ds.Modality = "CT"
        ds.PatientName = "Cheese^Synthetic"
        ds.PatientID = "TOMOCHEESE"
        ds.PixelSpacing = [mm_per_pixel, mm_per_pixel]
        ds.SliceThickness = slice_thickness_mm
        ds.RescaleSlope = 1.0
        ds.RescaleIntercept = -1000.0
        ds.ImagePositionPatient = [0.0, 0.0, float(z)]
        ds.InstanceNumber = i + 1
        ds.set_pixel_data(stored)
        path = str(Path(dir_out) / f"cheese_{i:03d}.dcm")
        dcm.dcmwrite(path, ds)
        paths.append(path)
    return paths


ACR_CT_PLUGS = {  # angle (deg, y-down), HU
    "Air": (45, -1000),
    "Poly": (225, -95),
    "Acrylic": (135, 120),
    "Bone": (-45, 955),
    "Water": (180, 0),
}


def generate_acr_ct(
    dir_out: str | Path,
    num_slices: int = 32,
    slice_thickness_mm: float = 5.0,
    mm_per_pixel: float = 0.5,
    image_size: int = 512,
    phantom_radius_mm: float = 100,
    roll_deg: float = 0.0,
    noise_hu: float = 3.0,
    seed: int = 21,
) -> list[str]:
    """Write a synthetic ACR CT-464 series: water cylinder with the four
    modules of ``pylinac_tpu_torch.acr`` at their nominal offsets."""
    rng = np.random.default_rng(seed)
    os.makedirs(dir_out, exist_ok=True)
    center = image_size / 2 - 0.5
    r_phan_px = phantom_radius_mm / mm_per_pixel
    series_uid = dcm.generate_uid()
    study_uid = dcm.generate_uid()
    frame_uid = dcm.generate_uid()
    paths = []
    # modules: HU @0, LC @30, uniformity @70, spatial res @100
    z_positions = (np.arange(num_slices) - 4) * slice_thickness_mm
    roll = np.deg2rad(roll_deg)
    yy, xx = np.mgrid[:image_size, :image_size]
    in_phantom = (yy - center) ** 2 + (xx - center) ** 2 < r_phan_px**2

    def polar_to_px(angle_deg, dist_mm):
        a = np.deg2rad(angle_deg) + roll
        return (center + np.cos(a) * dist_mm / mm_per_pixel,
                center + np.sin(a) * dist_mm / mm_per_pixel)

    for i, z in enumerate(z_positions):
        hu = np.full((image_size, image_size), -1000.0)
        hu[in_phantom] = 0.0

        if abs(z) <= 9:  # HU module
            for _name, (angle, value) in ACR_CT_PLUGS.items():
                px, py = polar_to_px(angle, 63)
                _disk(hu, px, py, 10 / mm_per_pixel, value)
            # two air bubbles vertically aligned on the right for roll
            for dy in (-25, 25):
                a = roll
                bx = center + (70 * np.cos(a) - dy * np.sin(a)) / mm_per_pixel
                by = center + (70 * np.sin(a) + dy * np.cos(a)) / mm_per_pixel
                _disk(hu, bx, by, 14 / mm_per_pixel, -1000)
        if abs(z - 30) <= 9:  # low contrast: 30 HU disk + uniform bg
            px, py = polar_to_px(-90, 60)
            _disk(hu, px, py, 12 / mm_per_pixel, 30.0)
        if abs(z - 100) <= 9:  # spatial resolution bar patterns
            amplitudes = [400, 360, 310, 260, 210, 160, 110, 60]
            settings = [(-135, 0.4), (-180, 0.5), (135, 0.6), (90, 0.7),
                        (45, 0.8), (0, 0.9), (-45, 1.0), (-90, 1.2)]
            for amp, (angle, _lpmm) in zip(amplitudes, settings):
                px, py = polar_to_px(angle, 70)
                rr_px = 8 / mm_per_pixel
                mask = (yy - py) ** 2 + (xx - px) ** 2 <= rr_px**2
                stripes = np.where((xx // 3) % 2 == 0, amp, -amp)
                hu[mask] = stripes[mask] + 100

        noise = rng.standard_normal((image_size, image_size))
        noise = _smooth(_smooth(_smooth(noise)))
        noise *= noise_hu / max(noise.std(), 1e-9)
        hu += noise
        stored = np.clip(hu + 1000, 0, 65535).astype(np.uint16)
        ds = dcm.Dataset()
        ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
        ds.SOPInstanceUID = dcm.generate_uid()
        ds.StudyInstanceUID = study_uid
        ds.SeriesInstanceUID = series_uid
        ds.FrameOfReferenceUID = frame_uid
        ds.Modality = "CT"
        ds.PatientName = "ACR^Synthetic"
        ds.PatientID = "ACRCT464"
        ds.PixelSpacing = [mm_per_pixel, mm_per_pixel]
        ds.SliceThickness = slice_thickness_mm
        ds.RescaleSlope = 1.0
        ds.RescaleIntercept = -1000.0
        ds.ImagePositionPatient = [0.0, 0.0, float(z)]
        ds.InstanceNumber = i + 1
        ds.set_pixel_data(stored)
        path = str(Path(dir_out) / f"acrct_{i:03d}.dcm")
        dcm.dcmwrite(path, ds)
        paths.append(path)
    return paths


def generate_helios(
    dir_out: str | Path,
    num_slices: int = 40,
    slice_thickness_mm: float = 2.5,
    mm_per_pixel: float = 0.6,
    image_size: int = 512,
    phantom_radius_mm: float = 107.5,
    noise_hu: float = 3.0,
    seed: int = 11,
) -> list[str]:
    """Write a synthetic GE Helios daily-QA series: water cylinder with the
    Section-1 Plexiglass block + bar patterns at z=0 and uniform water at
    Section 3 (+60mm)."""
    rng = np.random.default_rng(seed)
    os.makedirs(dir_out, exist_ok=True)
    center = image_size / 2 - 0.5
    r_phan_px = phantom_radius_mm / mm_per_pixel
    series_uid = dcm.generate_uid()
    study_uid = dcm.generate_uid()
    frame_uid = dcm.generate_uid()
    paths = []
    z_positions = (np.arange(num_slices) - 8) * slice_thickness_mm
    yy, xx = np.mgrid[:image_size, :image_size]
    in_phantom = (yy - center) ** 2 + (xx - center) ** 2 < r_phan_px**2

    def polar_to_px(angle_deg, dist_mm):
        a = np.deg2rad(angle_deg)
        return (center + np.cos(a) * dist_mm / mm_per_pixel,
                center + np.sin(a) * dist_mm / mm_per_pixel)

    # physical bar blocks: one material (+400 HU) against water, bar width =
    # the nominal size; the measured michelson MTF then declines with spatial
    # frequency through the reconstruction blur below, exactly like the real
    # phantom (bipolar ±amp bars would put max+min ≈ 0 and make the
    # michelson denominator noise — the MTF ordering was random).
    bar_settings = [(-53, 42, 8, 1.6), (-62, 21, 7, 1.3),
                    (-120, 5, 6, 1.0), (146, 16, 5, 0.8)]
    bar_hu = 400.0
    for i, z in enumerate(z_positions):
        hu = np.full((image_size, image_size), -1000.0)
        hu[in_phantom] = 0.0  # water

        if abs(z) <= 6:  # Section 1
            # Plexiglass block at -135deg 35mm
            px, py = polar_to_px(-135, 35)
            half = 8 / mm_per_pixel
            hu[int(py - half):int(py + half), int(px - half):int(px + half)] = 120
            # anti-aliased bar coverage (2x subpixel supersampling along the
            # stripe axis; periods are 2.7-5.3 px at 0.6 mm/px)
            for angle, dist, size, bar in bar_settings:
                px, py = polar_to_px(angle, dist)
                # block 1.5x the sampling ROI so the ROI reads pure bar
                # pattern — if the block boundary (bar-to-water ramp) falls
                # inside the ROI, roi.min pins near 0 and the michelson MTF
                # floor never decays no matter the blur
                half = size * 1.5 / 2 / mm_per_pixel
                region = (slice(int(py - half), int(py + half)),
                          slice(int(px - half), int(px + half)))
                period_px = 2 * bar / mm_per_pixel
                cov = np.zeros_like(xx, dtype=float)
                for ox in (-0.25, 0.25):
                    cov += 0.5 * (np.sin(2 * np.pi * (xx + ox) / period_px) > 0)
                hu[region] = bar_hu * cov[region]
            # finite scanner resolution: two binomial passes attenuate the
            # 0.8 mm bars (f=0.375 cyc/px) ~20x more than the 1.6 mm bars —
            # a declining, monotonic MTF whose 10% point falls inside the
            # 0.31-0.63 lp/mm bar range, so relative_resolution(10..90)
            # interpolates instead of warning about extrapolation
            hu = _smooth(_smooth(hu))
        noise = rng.standard_normal((image_size, image_size))
        noise = _smooth(_smooth(_smooth(noise)))
        noise *= noise_hu / max(noise.std(), 1e-9)
        hu += noise
        stored = np.clip(hu + 1000, 0, 65535).astype(np.uint16)
        ds = dcm.Dataset()
        ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
        ds.SOPInstanceUID = dcm.generate_uid()
        ds.StudyInstanceUID = study_uid
        ds.SeriesInstanceUID = series_uid
        ds.FrameOfReferenceUID = frame_uid
        ds.Modality = "CT"
        ds.PatientName = "Helios^Synthetic"
        ds.PatientID = "HELIOS"
        ds.PixelSpacing = [mm_per_pixel, mm_per_pixel]
        ds.SliceThickness = slice_thickness_mm
        ds.RescaleSlope = 1.0
        ds.RescaleIntercept = -1000.0
        ds.ImagePositionPatient = [0.0, 0.0, float(z)]
        ds.InstanceNumber = i + 1
        ds.set_pixel_data(stored)
        path = str(Path(dir_out) / f"helios_{i:03d}.dcm")
        dcm.dcmwrite(path, ds)
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# test and smoke data: CatPhan 503, 600, 604 and 700 series and a CBCT of a BB
# ---------------------------------------------------------------------------
# the CatPhan 700's plugs (``ct.CTP404CP700.roi_settings``): angle (deg,
# y-down image convention), HU
CP700_PLUGS = {
    "Air": (270, -1000), "PMP": (300, -196), "Lung": (345, -868), "Delrin": (15, 365),
    "Poly": (60, -47), "Teflon": (90, 1000), "Bone 20%": (120, 237), "LDPE": (165, -104),
    "Bone 50%": (195, 725), "Acrylic": (240, 115), "Vial": (315, 0),
}
# its bar groups (``ct.CTP528CP700.roi_settings``): lp/mm, radial and
# transversal distance (mm), rotation (deg), ROI width and height (mm)
CP700_BARS = (
    (0.1, 50, -7, -90, 3, 11), (0.2, 50, 11, -90, 3, 11), (0.3, 50, -5.5, -45, 3, 10),
    (0.4, 50, 9.5, -45, 3, 8.5), (0.5, 50, -9, 0, 3, 8), (0.6, 50, 2, 0, 3, 7),
    (0.7, 50, 12, 0, 3, 6), (0.8, 50, -10.5, 45, 3, 4),
)
# module offsets from CTP404 (``ct.CatPhan700.modules``), mm
CP700_CTP528_OFFSET = -40
CP700_CTP515_OFFSET = -80
CP700_CTP486_OFFSET = -160


def _gaussian_blur(arr: np.ndarray, sigma_px: float) -> np.ndarray:
    """Separable Gaussian blur, edges held at their value."""
    radius = int(np.ceil(4 * sigma_px))
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma_px) ** 2)
    k /= k.sum()
    out = arr
    for ax in (0, 1):
        padded = np.pad(out, [(radius, radius) if a == ax else (0, 0) for a in (0, 1)],
                        mode="edge")
        out = sum(k[i] * np.take(padded, np.arange(i, i + out.shape[ax]), axis=ax)
                  for i in range(len(k)))
    return out


def _bar_template(center: float, image_size: int, mm_per_pixel: float,
                  bar_hu: float, blur_mm: float, supersample: int = 4) -> np.ndarray:
    """The CTP714 bar groups as HU over a 0 HU background: each group fills
    its ROI rectangle (plus 0.75 mm along the bars' period and 1 mm across)
    with bars of half the period, starting with a bar at the group's edge;
    each pixel averages ``supersample``**2 sub-samples, then a Gaussian of
    ``blur_mm`` stands for the scanner's resolution."""
    offs = (np.arange(supersample) + 0.5) / supersample - 0.5
    yy, xx = np.mgrid[:image_size, :image_size].astype(np.float64)
    cov = np.zeros((image_size, image_size))
    for lpmm, radial, transversal, rotation, width, height in CP700_BARS:
        rot = np.deg2rad(rotation)
        c, s = np.cos(rot), np.sin(rot)
        cx = center + (radial * c - transversal * s) / mm_per_pixel
        cy = center + (radial * s + transversal * c) / mm_per_pixel
        half_w, half_h = width / 2 + 1.0, height / 2 + 0.75
        period = 1 / lpmm
        for oy in offs:
            for ox in offs:
                dx = (xx + ox - cx) * mm_per_pixel
                dy = (yy + oy - cy) * mm_per_pixel
                # the group's own frame: u across the bars, v along the period
                u = dx * c + dy * s
                v = -dx * s + dy * c
                inside = (np.abs(u) <= half_w) & (np.abs(v) <= half_h)
                bars = np.mod(v + half_h, period) < period / 2
                cov += (inside & bars) / supersample**2
    return _gaussian_blur(cov * bar_hu, blur_mm / mm_per_pixel)


def _write_ct_slice(path, stored: np.ndarray, z: float, index: int, uids: tuple,
                    mm_per_pixel: float, slice_thickness_mm: float, intercept: float,
                    transfer_syntax: str) -> None:
    study_uid, series_uid, frame_uid = uids
    ds = dcm.Dataset()
    ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
    ds.SOPInstanceUID = dcm.generate_uid()
    ds.StudyInstanceUID = study_uid
    ds.SeriesInstanceUID = series_uid
    ds.FrameOfReferenceUID = frame_uid
    ds.Modality = "CT"
    ds.PatientName = "CatPhan^Synthetic"
    ds.PixelSpacing = [mm_per_pixel, mm_per_pixel]
    ds.SliceThickness = slice_thickness_mm
    ds.RescaleSlope = 1.0
    ds.RescaleIntercept = intercept
    ds.ImagePositionPatient = [0.0, 0.0, float(z)]
    ds.InstanceNumber = index + 1
    ds.set_pixel_data(stored)
    dcm.dcmwrite(path, ds, transfer_syntax=transfer_syntax)


# the other models' plugs (``ct.CTP404CP600`` and ``ct.CTP404CP604``; the 503
# has the 504's ``HU_PLUGS``): angle (deg, y-down image convention), HU
CP600_PLUGS = {
    "Air": (90, -1000), "PMP": (60, -196), "LDPE": (0, -104), "Poly": (-60, -47),
    "Acrylic": (-120, 115), "Delrin": (-180, 365), "Teflon": (120, 1000), "Vial": (-90, 0),
}
CP604_PLUGS = {
    "Air": (-90, -1000), "PMP": (-120, -196), "50% Bone": (-150, 725), "LDPE": (180, -104),
    "Poly": (120, -47), "Acrylic": (60, 115), "20% Bone": (30, 237), "Delrin": (0, 365),
    "Teflon": (-60, 1000),
}
# the CTP515 disks' angles (deg) at 50 mm: ``ct.CTP515`` and ``ct.CTP515CP600``
CP504_LOW_CONTRAST_ANGLES = (-87.4, -69.1, -52.7, -38.5, -25.1, -12.9)
CP600_LOW_CONTRAST_ANGLES = (92.6, 110.9, 127.3, 141.5, 154.9, 167.1)
LOW_CONTRAST_RADII_MM = (6, 3.5, 3, 2.5, 2, 1.5)
# air bubbles for the roll: one of 5 mm at 73 mm, beyond the air plug and
# in line with it (the wire ramps at 38 mm and the plug at 58.7 mm leave
# too little room between them for a bubble whose edge does not join
# theirs); the 700's two of 5 mm at 45 mm above and below the centre
OUTER_BUBBLE_TOP = ((-90, 73, 5.0),)
OUTER_BUBBLE_BOTTOM = ((90, 73, 5.0),)
CP700_BUBBLES = ((-90, 45, 5.0), (90, 45, 5.0))
# each model (``ct.CatPhan503/600/604/700``): the body's radius (mm), the
# CTP404 plugs, the angles of the plug-sized water disks at the CTP404's
# background ROIs, the CTP528, CTP515 and CTP486 offsets from CTP404 (mm;
# None where the model has no such module), the CTP528 gauge's start
# angle, direction and region boundaries (None: the 700's bar groups), the
# CTP515 disks' angles, and the default slice count and CTP404 position
# (mm), which put every module inside the scan
CATPHAN_MODELS = {
    "503": dict(radius=97, plugs=HU_PLUGS, water=(), ctp528=-30, ctp515=None, ctp486=-110,
                gauge=(np.pi, True, CP504_GAUGE_BOUNDARIES), low_contrast=None,
                bubbles=OUTER_BUBBLE_TOP, num_slices=60, ctp404_z=50.0),
    "600": dict(radius=101, plugs=CP600_PLUGS, water=(), ctp528=-70, ctp515=-110,
                ctp486=-160,
                gauge=(np.pi - 0.1, False,
                       (0, 0.127, 0.195, 0.255, 0.304, 0.354, 0.405, 0.453, 0.496)),
                low_contrast=CP600_LOW_CONTRAST_ANGLES, bubbles=OUTER_BUBBLE_BOTTOM,
                num_slices=80, ctp404_z=75.0),
    "604": dict(radius=101, plugs=CP604_PLUGS, water=(-30, -210), ctp528=40, ctp515=-40,
                ctp486=-80, gauge=(np.pi, True, CP504_GAUGE_BOUNDARIES),
                low_contrast=CP504_LOW_CONTRAST_ANGLES, bubbles=OUTER_BUBBLE_TOP,
                num_slices=60, ctp404_z=20.0),
    "700": dict(radius=101, plugs=CP700_PLUGS, water=(), ctp528=CP700_CTP528_OFFSET,
                ctp515=CP700_CTP515_OFFSET, ctp486=CP700_CTP486_OFFSET, gauge=None,
                low_contrast=CP600_LOW_CONTRAST_ANGLES, bubbles=CP700_BUBBLES,
                num_slices=80, ctp404_z=70.0),
}


def _generate_catphan(
    dir_out: str | Path,
    model: str,
    num_slices: int | None = None,
    slice_thickness_mm: float = 2.5,
    mm_per_pixel: float = 0.5,
    image_size: int = 512,
    ctp404_z_mm: float | None = None,
    noise_hu: float = 3.0,
    bar_hu: float = 1000.0,
    bar_blur_mm: float = 0.4,
    low_contrast_hu: float = 10.0,
    vial: bool = True,
    seed: int = 1234,
    transfer_syntax: str = dcm.EXPLICIT_VR_LE,
) -> list[str]:
    """Write a synthetic CatPhan 503, 600, 604 or 700 (``model``) series of
    int16 slices (HU, intercept 0); returns the file paths. Test and smoke
    data, not a public generator.

    A water cylinder of the model's radius holds, at the model's offsets
    from ``ctp404_z_mm`` (``CATPHAN_MODELS``; its default puts every module
    inside the model's default ``num_slices``): CTP404 (the model's plugs
    at their nominal HU and angles, the 604's background ROIs as water
    disks, the wire ramps, central hole and geometry nodes of
    :func:`generate_catphan504`, and the model's air bubbles), the
    spatial-resolution module (the line-pair gauge of
    :func:`generate_catphan504` along the model's circle profile, or the
    700's eight bar groups inside ``CTP528CP700``'s rectangles, blurred by
    ``bar_blur_mm``), the model's CTP515 low-contrast disks (none on the
    503) and a uniform CTP486. ``vial=False`` leaves the 600's water vial
    out: its hole reads as air. Slices sit at (i - n/2) x thickness.
    Band-limited noise of ``noise_hu`` is drawn from ``seed``."""
    spec = CATPHAN_MODELS[model]
    num_slices = spec["num_slices"] if num_slices is None else num_slices
    ctp404_z_mm = spec["ctp404_z"] if ctp404_z_mm is None else ctp404_z_mm
    rng = np.random.default_rng(seed)
    os.makedirs(dir_out, exist_ok=True)
    center = image_size / 2 - 0.5
    uids = (dcm.generate_uid(), dcm.generate_uid(), dcm.generate_uid())
    z_positions = (np.arange(num_slices) - num_slices / 2) * slice_thickness_mm
    yy, xx = np.mgrid[:image_size, :image_size]
    phantom = np.full((image_size, image_size), -1000.0)
    phantom[(yy - center) ** 2 + (xx - center) ** 2 < (spec["radius"] / mm_per_pixel) ** 2] = 0.0

    def polar_to_px(angle_deg, dist_mm):
        a = np.deg2rad(angle_deg)
        return (center + np.cos(a) * dist_mm / mm_per_pixel,
                center + np.sin(a) * dist_mm / mm_per_pixel)

    hu_module = phantom.copy()
    hu_module[(yy - center) ** 2 + (xx - center) ** 2 < (95 / mm_per_pixel) ** 2] = 45.0
    plugs = [(angle, -1000 if name == "Vial" and not vial else value)
             for name, (angle, value) in spec["plugs"].items()]
    for angle, value in plugs + [(angle, 0) for angle in spec["water"]]:
        _disk(hu_module, *polar_to_px(angle, PLUG_DIST_MM), PLUG_RADIUS_MM / mm_per_pixel, value)
    for angle, dist_mm, radius_mm in spec["bubbles"]:
        _disk(hu_module, *polar_to_px(angle, dist_mm), radius_mm / mm_per_pixel, -1000)
    if spec["gauge"] is None:
        resolution_module = phantom + _bar_template(center, image_size, mm_per_pixel,
                                                    bar_hu, bar_blur_mm)
    else:
        start_angle, ccw, boundaries = spec["gauge"]
        resolution_module = _draw_gauge(phantom.copy(), yy, xx, center, mm_per_pixel, 0.0,
                                        start_angle, ccw, boundaries)
    low_contrast_module = phantom.copy()
    for angle, radius_mm in zip(spec["low_contrast"] or (), LOW_CONTRAST_RADII_MM):
        _disk(low_contrast_module, *polar_to_px(angle, 50), radius_mm / mm_per_pixel,
              low_contrast_hu)

    paths = []
    for i, z in enumerate(z_positions):
        dz = z - ctp404_z_mm
        if abs(dz) <= 20:
            hu = hu_module.copy()
        elif abs(dz - spec["ctp528"]) <= 10:
            hu = resolution_module.copy()
        elif spec["ctp515"] is not None and abs(dz - spec["ctp515"]) <= 8:
            hu = low_contrast_module.copy()
        else:
            hu = phantom.copy()
        if abs(dz) <= slice_thickness_mm * 1.6:
            # the 504 generator's 23-degree wire ramps, central hole and
            # geometry nodes
            lo_px = (dz - slice_thickness_mm / 2) / (0.42 * mm_per_pixel)
            hi_px = (dz + slice_thickness_mm / 2) / (0.42 * mm_per_pixel)
            t = max(int(round(0.4 / mm_per_pixel)), 1)
            for angle, horiz in ((180, False), (0, False), (90, True), (-90, True)):
                px, py = polar_to_px(angle, 38)
                lo = int(round(px + lo_px)) if horiz else int(round(py + lo_px))
                hi = int(round(px + hi_px)) if horiz else int(round(py + hi_px))
                if horiz:
                    hu[int(py) - t: int(py) + t + 1, lo:hi] = 800
                else:
                    hu[lo:hi, int(px) - t: int(px) + t + 1] = 800
            _disk(hu, center, center, 1.2 / mm_per_pixel, -1000)
            for dx, dy in ((-25, -25), (25, -25), (-25, 25), (25, 25)):
                _disk(hu, center + dx / mm_per_pixel, center + dy / mm_per_pixel,
                      2.5 / mm_per_pixel, 900)
        noise = _smooth(_smooth(_smooth(rng.normal(0, noise_hu, hu.shape))))
        hu += noise * (noise_hu / max(noise.std(), 1e-9))
        path = str(Path(dir_out) / f"ct_{i:03d}.dcm")
        _write_ct_slice(path, np.clip(np.round(hu), -32768, 32767).astype(np.int16), z, i,
                        uids, mm_per_pixel, slice_thickness_mm, 0.0, transfer_syntax)
        paths.append(path)
    return paths


def _generate_catphan700(dir_out: str | Path, **kwargs) -> list[str]:
    """:func:`_generate_catphan` of a CatPhan 700: CTP404 at +70 mm of 80
    slices by default, CTP714 at -40 mm, CTP515 at -80 mm and CTP486 at
    -160 mm from it."""
    return _generate_catphan(dir_out, "700", **kwargs)


def _generate_cbct_bb(
    dir_out: str | Path,
    num_slices: int = 80,
    image_size: int = 256,
    mm_per_pixel: float = 0.5,
    slice_thickness_mm: float = 1.0,
    bb_offset_mm: tuple[float, float, float] = (2.0, -1.0, 3.0),
    seed: int = 0,
    transfer_syntax: str = dcm.EXPLICIT_VR_LE,
) -> list[str]:
    """Write a synthetic kV CBCT of a 5 mm BB (8000 HU in -1000 HU air,
    sigma 5 HU noise, uint16 with intercept -1024) offset by (x, y, z) mm
    from the volume's centre; returns the file paths. Test and smoke data:
    ``tests/models/test_winstonlutz.py:124-157``'s fixture, whose pixels it
    gives at its default size and seed."""
    from ..core.array_utils import array_to_dicom

    os.makedirs(dir_out, exist_ok=True)
    nz, ny, nx = num_slices, image_size, image_size
    off_x_mm, off_y_mm, off_z_mm = bb_offset_mm
    cy, cx, cz = (ny - 1) / 2, (nx - 1) / 2, (nz - 1) / 2
    vol = np.full((nz, ny, nx), -1000.0)
    yy, xx = np.mgrid[:ny, :nx]
    for z in range(nz):
        dz_mm = (z - cz) * slice_thickness_mm - off_z_mm
        r2_mm = 2.5**2 - dz_mm**2
        if r2_mm > 0:
            mask = ((yy - cy - off_y_mm / mm_per_pixel) ** 2
                    + (xx - cx - off_x_mm / mm_per_pixel) ** 2) * mm_per_pixel**2 <= r2_mm
            vol[z][mask] = 8000.0
    vol += np.random.default_rng(seed).normal(0, 5, vol.shape)
    series = dcm.generate_uid()
    paths = []
    for z in range(nz):
        u16 = np.clip(vol[z] + 1024, 0, 65535).astype(np.uint16)
        ds = array_to_dicom(
            u16, sid=1000, gantry=0, coll=0, couch=0, dpi=25.4 / mm_per_pixel,
            extra_tags={"SeriesInstanceUID": series,
                        "ImagePositionPatient": [0.0, 0.0, float(z * slice_thickness_mm)],
                        "SliceThickness": slice_thickness_mm,
                        "PixelSpacing": [mm_per_pixel, mm_per_pixel],
                        "RescaleSlope": 1.0, "RescaleIntercept": -1024.0, "Modality": "CT"})
        path = str(Path(dir_out) / f"{z:03d}.dcm")
        dcm.dcmwrite(path, ds, transfer_syntax=transfer_syntax)
        paths.append(path)
    return paths
