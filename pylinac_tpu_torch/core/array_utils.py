"""Host array helpers the synthetic image generator needs, numpy only.

Port of ``array_to_dicom`` (``pylinac_tpu/core/array_utils.py:143``) and
``_rt_image_position`` (``:136``). The port's simulators make integer arrays
only, so the JAX function's float-to-uint16 rescale is not carried over: a
float array is rejected by ``Dataset.set_pixel_data``.
"""

from __future__ import annotations

import numpy as np

from . import dcm


def _rt_image_position(array: np.ndarray, dpmm: float) -> list[float]:
    """RT Image Position tag value for an array centred at the origin."""
    rows, cols = array.shape
    px = 1.0 / dpmm
    return [-(cols * px / 2) + px / 2, -(rows * px / 2) + px / 2]


def array_to_dicom(array: np.ndarray, sid: float, gantry: float, coll: float,
                   couch: float, dpi: float | None = None,
                   extra_tags: dict | None = None) -> dcm.Dataset:
    """An RT Image DICOM dataset holding a 2D integer array."""
    if array.ndim != 2:
        raise ValueError("Array must be 2D")
    ds = dcm.Dataset()
    ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.481.1"  # RT Image Storage
    ds.SOPInstanceUID = dcm.generate_uid()
    ds.StudyInstanceUID = dcm.generate_uid()
    ds.SeriesInstanceUID = dcm.generate_uid()
    ds.Modality = "RTIMAGE"
    ds.ImageType = ["ORIGINAL", "PRIMARY", "PORTAL"]
    ds.PatientName = "pylinac-tpu"
    ds.PatientID = "123456789"
    ds.RTImageSID = sid
    ds.RadiationMachineSAD = 1000.0
    ds.GantryAngle = gantry
    ds.BeamLimitingDeviceAngle = coll
    ds.PatientSupportAngle = couch
    if dpi is not None:
        dpmm = dpi / 25.4
        pixel_mm = 1.0 / dpmm
        ds.ImagePlanePixelSpacing = [pixel_mm, pixel_mm]
        ds.RTImagePosition = _rt_image_position(array, dpmm)
    ds.set_pixel_data(np.ascontiguousarray(array))
    if extra_tags:
        for key, value in extra_tags.items():
            setattr(ds, key, value)
    return ds
