"""Synthetic CatPhan 504 CT stacks, numpy only.

Port of ``generate_catphan504`` (``pylinac_tpu/imggen/ct.py:56-222``) with
its helpers, unchanged apart from the DICOM codec (the port's
``core/dcm.py``): a DICOM CT series emulating a CatPhan 504, a 20 cm water
cylinder with the CTP404 (HU plugs, air bubbles, wire ramps, geometry
nodes), CTP486 (uniformity), CTP528 (line-pair gauge) and CTP515
(low-contrast bubbles) modules at their nominal z-offsets. The same seed
gives the same pixels as the JAX package's generator. The Quart, Cheese,
ACR and Helios generators wait for their analyses.
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
            r_gauge = 47.0
            boundaries = (0, 0.107, 0.173, 0.236, 0.286, 0.335, 0.387, 0.434, 0.479)
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
                    f = ((np.pi - theta) % (2 * np.pi)) / (2 * np.pi)
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
