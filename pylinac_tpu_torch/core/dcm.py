"""Self-contained DICOM codec (reader + writer), numpy only.

Carried over from ``pylinac_tpu/core/dcm.py`` (reader ``dcmread`` ``:635``,
writer ``dcmwrite`` ``:804``) for the uncompressed transfer syntaxes. The
compressed ones (RLE, JPEG Lossless, JPEG-LS, JPEG 2000; JAX
``core/compressed_px.py`` and ``core/jpegls.py``) are not ported yet: a file
in one of them is rejected with ``InvalidDicomError``. Supported:

* reading implicit/explicit VR little-endian (and explicit big-endian)
  datasets, with or without the 128-byte preamble,
* nested sequences (defined and undefined length),
* pixel decoding for 8/16/32-bit integer and 32/64-bit float grayscale data,
* writing explicit VR little-endian files (round-trip safe for the tags we
  touch), including multi-frame and RT Plan sequence data.
"""

from __future__ import annotations

import io
import os
import struct
import uuid
from pathlib import Path
from typing import Any, BinaryIO, Iterator

import numpy as np

# --- Transfer syntaxes -----------------------------------------------------
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"
_SUPPORTED_TS = {IMPLICIT_VR_LE, EXPLICIT_VR_LE, EXPLICIT_VR_BE}

# UID root used for generated UIDs (the generic "2.25 + uuid" DICOM form).
def generate_uid() -> str:
    return "2.25." + str(uuid.uuid4().int)


# --- VR handling -----------------------------------------------------------
# VRs with a 2-byte reserved field + 4-byte length in explicit VR encoding.
_LONG_VRS = {"OB", "OW", "OF", "OD", "OL", "OV", "SQ", "UC", "UR", "UT", "UN"}
_BINARY_FMT = {"US": "H", "SS": "h", "UL": "I", "SL": "l", "FL": "f", "FD": "d",
               "UV": "Q", "SV": "q"}
_STRING_VRS = {"AE", "AS", "CS", "DA", "DT", "LO", "LT", "PN", "SH", "ST",
               "TM", "UI", "UT", "UC", "UR"}

_ITEM_TAG = 0xFFFEE000
_ITEM_DELIM_TAG = 0xFFFEE00D
_SEQ_DELIM_TAG = 0xFFFEE0DD
_UNDEFINED = 0xFFFFFFFF


def _tag_int(group: int, elem: int) -> int:
    return (group << 16) | elem


# --- Minimal data dictionary ----------------------------------------------
# keyword -> (tag, VR).  Covers every attribute the framework reads/writes;
# unknown tags still round-trip as raw elements.
DICT: dict[str, tuple[int, str]] = {
    # File meta (group 0002)
    "FileMetaInformationGroupLength": (0x00020000, "UL"),
    "FileMetaInformationVersion": (0x00020001, "OB"),
    "MediaStorageSOPClassUID": (0x00020002, "UI"),
    "MediaStorageSOPInstanceUID": (0x00020003, "UI"),
    "TransferSyntaxUID": (0x00020010, "UI"),
    "ImplementationClassUID": (0x00020012, "UI"),
    "ImplementationVersionName": (0x00020013, "SH"),
    # Identification
    "SpecificCharacterSet": (0x00080005, "CS"),
    "ImageType": (0x00080008, "CS"),
    "InstanceCreationDate": (0x00080012, "DA"),
    "InstanceCreationTime": (0x00080013, "TM"),
    "SOPClassUID": (0x00080016, "UI"),
    "SOPInstanceUID": (0x00080018, "UI"),
    "StudyDate": (0x00080020, "DA"),
    "SeriesDate": (0x00080021, "DA"),
    "AcquisitionDate": (0x00080022, "DA"),
    "ContentDate": (0x00080023, "DA"),
    "StudyTime": (0x00080030, "TM"),
    "SeriesTime": (0x00080031, "TM"),
    "AcquisitionTime": (0x00080032, "TM"),
    "ContentTime": (0x00080033, "TM"),
    "AccessionNumber": (0x00080050, "SH"),
    "Modality": (0x00080060, "CS"),
    "Manufacturer": (0x00080070, "LO"),
    "InstitutionName": (0x00080080, "LO"),
    "ReferringPhysicianName": (0x00080090, "PN"),
    "StationName": (0x00081010, "SH"),
    "StudyDescription": (0x00081030, "LO"),
    "SeriesDescription": (0x0008103E, "LO"),
    "OperatorsName": (0x00081070, "PN"),
    "ManufacturerModelName": (0x00081090, "LO"),
    "ReferencedSOPClassUID": (0x00081150, "UI"),
    "ReferencedSOPInstanceUID": (0x00081155, "UI"),
    # Patient
    "PatientName": (0x00100010, "PN"),
    "PatientID": (0x00100020, "LO"),
    "PatientBirthDate": (0x00100030, "DA"),
    "PatientSex": (0x00100040, "CS"),
    # Acquisition
    "KVP": (0x00180060, "DS"),
    "SliceThickness": (0x00180050, "DS"),
    "SpacingBetweenSlices": (0x00180088, "DS"),
    "ExposureTime": (0x00181150, "IS"),
    "XRayTubeCurrent": (0x00181151, "IS"),
    "Exposure": (0x00181152, "IS"),
    "ConvolutionKernel": (0x00181210, "SH"),
    "GantryDetectorTilt": (0x00181120, "DS"),
    "TableHeight": (0x00181130, "DS"),
    "RotationDirection": (0x00181140, "CS"),
    "CollimatorType": (0x00181700, "CS"),
    "ActualFrameDuration": (0x00181242, "IS"),
    "CountsAccumulated": (0x00180070, "IS"),
    "PatientPosition": (0x00185100, "CS"),
    "MagneticFieldStrength": (0x00180087, "DS"),
    "EchoNumbers": (0x00180086, "IS"),
    "EchoTime": (0x00180081, "DS"),
    "RepetitionTime": (0x00180080, "DS"),
    "ReconstructionDiameter": (0x00181100, "DS"),
    "DataCollectionDiameter": (0x00180090, "DS"),
    "DistanceSourceToDetector": (0x00181110, "DS"),
    "DistanceSourceToPatient": (0x00181111, "DS"),
    # Relationship
    "StudyInstanceUID": (0x0020000D, "UI"),
    "SeriesInstanceUID": (0x0020000E, "UI"),
    "StudyID": (0x00200010, "SH"),
    "SeriesNumber": (0x00200011, "IS"),
    "AcquisitionNumber": (0x00200012, "IS"),
    "InstanceNumber": (0x00200013, "IS"),
    "ImagePositionPatient": (0x00200032, "DS"),
    "ImageOrientationPatient": (0x00200037, "DS"),
    "FrameOfReferenceUID": (0x00200052, "UI"),
    "PositionReferenceIndicator": (0x00201040, "LO"),
    "SliceLocation": (0x00201041, "DS"),
    # Image pixel
    "SamplesPerPixel": (0x00280002, "US"),
    "PhotometricInterpretation": (0x00280004, "CS"),
    "NumberOfFrames": (0x00280008, "IS"),
    "FrameIncrementPointer": (0x00280009, "AT"),
    "Rows": (0x00280010, "US"),
    "Columns": (0x00280011, "US"),
    "PixelSpacing": (0x00280030, "DS"),
    "BitsAllocated": (0x00280100, "US"),
    "BitsStored": (0x00280101, "US"),
    "HighBit": (0x00280102, "US"),
    "PixelRepresentation": (0x00280103, "US"),
    "WindowCenter": (0x00281050, "DS"),
    "WindowWidth": (0x00281051, "DS"),
    "RescaleIntercept": (0x00281052, "DS"),
    "RescaleSlope": (0x00281053, "DS"),
    "RescaleType": (0x00281054, "LO"),
    "PixelIntensityRelationship": (0x00281040, "CS"),
    "PixelIntensityRelationshipSign": (0x00281041, "SS"),
    "PixelData": (0x7FE00010, "OW"),
    # RT image
    "RTImageLabel": (0x30020002, "SH"),
    "RTImageName": (0x30020003, "LO"),
    "RTImageDescription": (0x30020004, "ST"),
    "ImagePlanePixelSpacing": (0x30020011, "DS"),
    "ImagerPixelSpacing": (0x00181164, "DS"),
    "RTImagePosition": (0x30020012, "DS"),
    "RadiationMachineName": (0x30020020, "SH"),
    "RadiationMachineSAD": (0x30020022, "DS"),
    "RTImageSID": (0x30020026, "DS"),
    "XRayImageReceptorTranslation": (0x3002000D, "DS"),
    "XRayImageReceptorAngle": (0x3002000E, "DS"),
    "PrimaryDosimeterUnit": (0x300A00B3, "CS"),
    "GantryAngle": (0x300A011E, "DS"),
    "GantryPitchAngle": (0x300A014A, "FL"),
    "BeamLimitingDeviceAngle": (0x300A0120, "DS"),
    "PatientSupportAngle": (0x300A0122, "DS"),
    "TableTopVerticalPosition": (0x300A0128, "DS"),
    "TableTopLongitudinalPosition": (0x300A0129, "DS"),
    "TableTopLateralPosition": (0x300A012A, "DS"),
    "ExposureSequence": (0x30020030, "SQ"),
    "MetersetExposure": (0x30020032, "DS"),
    # RT plan
    "RTPlanLabel": (0x300A0002, "SH"),
    "RTPlanName": (0x300A0003, "LO"),
    "RTPlanDescription": (0x300A0004, "ST"),
    "RTPlanDate": (0x300A0006, "DA"),
    "RTPlanTime": (0x300A0007, "TM"),
    "RTPlanGeometry": (0x300A000C, "CS"),
    "FractionGroupSequence": (0x300A0070, "SQ"),
    "FractionGroupNumber": (0x300A0071, "IS"),
    "NumberOfFractionsPlanned": (0x300A0078, "IS"),
    "NumberOfBeams": (0x300A0080, "IS"),
    "NumberOfBrachyApplicationSetups": (0x300A00A0, "IS"),
    "ReferencedBeamSequence": (0x300C0004, "SQ"),
    "ReferencedBeamNumber": (0x300C0006, "IS"),
    "BeamMeterset": (0x300A0086, "DS"),
    "BeamSequence": (0x300A00B0, "SQ"),
    "BeamName": (0x300A00C2, "LO"),
    "BeamDescription": (0x300A00C3, "ST"),
    "BeamType": (0x300A00C4, "CS"),
    "RadiationType": (0x300A00C6, "CS"),
    "TreatmentMachineName": (0x300A00B2, "SH"),
    "SourceAxisDistance": (0x300A00B4, "DS"),
    "BeamNumber": (0x300A00C0, "IS"),
    "TreatmentDeliveryType": (0x300A00CE, "CS"),
    "NumberOfWedges": (0x300A00D0, "IS"),
    "NumberOfCompensators": (0x300A00E0, "IS"),
    "NumberOfBoli": (0x300A00ED, "IS"),
    "NumberOfBlocks": (0x300A00F0, "IS"),
    "FinalCumulativeMetersetWeight": (0x300A010E, "DS"),
    "NumberOfControlPoints": (0x300A0110, "IS"),
    "ControlPointSequence": (0x300A0111, "SQ"),
    "ControlPointIndex": (0x300A0112, "IS"),
    "NominalBeamEnergy": (0x300A0114, "DS"),
    "DoseRateSet": (0x300A0115, "DS"),
    "BeamLimitingDevicePositionSequence": (0x300A011A, "SQ"),
    "BeamLimitingDeviceSequence": (0x300A00B6, "SQ"),
    "RTBeamLimitingDeviceType": (0x300A00B8, "CS"),
    "NumberOfLeafJawPairs": (0x300A00BC, "IS"),
    "LeafPositionBoundaries": (0x300A00BE, "DS"),
    "LeafJawPositions": (0x300A011C, "DS"),
    "CumulativeMetersetWeight": (0x300A0134, "DS"),
    "SourceToBeamLimitingDeviceDistance": (0x300A00BA, "DS"),
    "PatientSetupSequence": (0x300A0180, "SQ"),
    "PatientSetupNumber": (0x300A0182, "IS"),
    "ReferencedPatientSetupNumber": (0x300C006A, "IS"),
    "DoseReferenceSequence": (0x300A0010, "SQ"),
    "ToleranceTableSequence": (0x300A0040, "SQ"),
    "ApprovalStatus": (0x300E0002, "CS"),
    "GantryRotationDirection": (0x300A011F, "CS"),
    "BeamLimitingDeviceRotationDirection": (0x300A0121, "CS"),
    "PatientSupportRotationDirection": (0x300A0123, "CS"),
    "TableTopEccentricAngle": (0x300A0125, "DS"),
    "TableTopEccentricRotationDirection": (0x300A0126, "CS"),
    "IsocenterPosition": (0x300A012C, "DS"),
    "PrimaryFluenceModeSequence": (0x30020050, "SQ"),
    "FluenceMode": (0x30020051, "CS"),
    "FluenceModeID": (0x30020052, "SH"),
    "ToleranceTableNumber": (0x300A0042, "IS"),
    "ReferencedToleranceTableNumber": (0x300C00A0, "IS"),
    "ReferencedDoseReferenceUID": (0x300A0083, "UI"),
    "BeamDose": (0x300A0084, "DS"),
    "DoseReferenceNumber": (0x300A0012, "IS"),
    "DoseReferenceUID": (0x300A0013, "UI"),
    "DoseReferenceStructureType": (0x300A0014, "CS"),
    "DoseReferenceDescription": (0x300A0016, "LO"),
    "DoseReferenceType": (0x300A0020, "CS"),
    "DeliveryMaximumDose": (0x300A0023, "DS"),
    "TargetPrescriptionDose": (0x300A0026, "DS"),
    "TargetMaximumDose": (0x300A0027, "DS"),
    # NM
    "RotationInformationSequence": (0x00540052, "SQ"),
    "NumberOfFramesInRotation": (0x00540053, "US"),
    "StartAngle": (0x00540200, "DS"),
    "AngularStep": (0x00540090, "DS"),
    "EnergyWindowInformationSequence": (0x00540012, "SQ"),
    "RadiopharmaceuticalInformationSequence": (0x00540016, "SQ"),
    "RadionuclideTotalDose": (0x00181074, "DS"),
    "RadiopharmaceuticalStartTime": (0x00181072, "TM"),
}

TAG_TO_KEYWORD: dict[int, str] = {tag: kw for kw, (tag, _vr) in DICT.items()}
TAG_TO_VR: dict[int, str] = {tag: vr for _kw, (tag, vr) in DICT.items()}


class InvalidDicomError(ValueError):
    pass


class DataElement:
    __slots__ = ("tag", "vr", "value")

    def __init__(self, tag: int, vr: str, value: Any):
        self.tag = tag
        self.vr = vr
        self.value = value

    @property
    def keyword(self) -> str:
        return TAG_TO_KEYWORD.get(self.tag, f"({self.tag >> 16:04X},{self.tag & 0xFFFF:04X})")

    def __repr__(self) -> str:  # pragma: no cover
        v = self.value
        if isinstance(v, bytes) and len(v) > 16:
            v = f"<{len(v)} bytes>"
        return f"({self.tag >> 16:04X},{self.tag & 0xFFFF:04X}) {self.vr} {self.keyword}: {v!r}"


class Dataset:
    """A DICOM dataset: ordered mapping of tag -> DataElement with
    pydicom-style attribute access (``ds.Rows``, ``ds.get('RescaleSlope')``)."""

    def __init__(self):
        object.__setattr__(self, "_elements", {})
        object.__setattr__(self, "file_meta", None)
        object.__setattr__(self, "_pixel_array", None)

    # -- mapping interface
    def add(self, element: DataElement) -> None:
        self._elements[element.tag] = element

    def __iter__(self) -> Iterator[DataElement]:
        return iter(sorted(self._elements.values(), key=lambda e: e.tag))

    def __contains__(self, keyword: str) -> bool:
        if keyword in DICT:
            return DICT[keyword][0] in self._elements
        return False

    def elements(self) -> dict[int, DataElement]:
        return self._elements

    def get(self, keyword: str, default: Any = None) -> Any:
        if keyword in DICT:
            el = self._elements.get(DICT[keyword][0])
            if el is not None:
                return el.value
        return default

    def __getattr__(self, name: str) -> Any:
        if name in DICT:
            el = self._elements.get(DICT[name][0])
            if el is not None:
                return el.value
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name in ("file_meta", "_pixel_array"):
            object.__setattr__(self, name, value)
            return
        if name in DICT:
            tag, vr = DICT[name]
            self._elements[tag] = DataElement(tag, vr, value)
        else:
            object.__setattr__(self, name, value)

    def __delattr__(self, name: str) -> None:
        if name in DICT and DICT[name][0] in self._elements:
            del self._elements[DICT[name][0]]
        else:
            object.__delattr__(self, name)

    def set_raw(self, group: int, elem: int, vr: str, value: Any) -> None:
        tag = _tag_int(group, elem)
        self._elements[tag] = DataElement(tag, vr, value)

    def get_raw(self, group: int, elem: int, default: Any = None) -> Any:
        el = self._elements.get(_tag_int(group, elem))
        return el.value if el is not None else default

    # -- pixel decoding
    @property
    def pixel_array(self) -> np.ndarray:
        if self._pixel_array is None:
            object.__setattr__(self, "_pixel_array", self._decode_pixels())
        return self._pixel_array

    def _decode_pixels(self) -> np.ndarray:
        el = self._elements.get(DICT["PixelData"][0])
        if el is None:
            raise AttributeError("Dataset has no PixelData")
        raw = el.value
        if isinstance(raw, list):
            raise InvalidDicomError("Encapsulated (compressed) pixel data is not supported")
        bits = int(self.get("BitsAllocated", 16))
        signed = int(self.get("PixelRepresentation", 0)) == 1
        rows = int(self.Rows)
        cols = int(self.Columns)
        nframes = int(self.get("NumberOfFrames", 1) or 1)
        samples = int(self.get("SamplesPerPixel", 1))
        if el.vr == "OF" or bits == 32 and el.vr == "FL":
            dtype = np.dtype("<f4")
        elif el.vr == "OD":
            dtype = np.dtype("<f8")
        else:
            dtype = np.dtype(f"<{'i' if signed else 'u'}{bits // 8}")
        count = rows * cols * nframes * samples
        arr = np.frombuffer(raw, dtype=dtype, count=count)
        if samples > 1:
            arr = arr.reshape(nframes, rows, cols, samples) if nframes > 1 else arr.reshape(rows, cols, samples)
        else:
            arr = arr.reshape(nframes, rows, cols) if nframes > 1 else arr.reshape(rows, cols)
        return arr

    def set_pixel_data(self, array: np.ndarray) -> None:
        """Set PixelData + image-pixel module tags from a 2D/3D numpy integer array."""
        arr = np.asarray(array)
        if arr.ndim == 3:
            self.NumberOfFrames = arr.shape[0]
            rows, cols = arr.shape[1], arr.shape[2]
        else:
            rows, cols = arr.shape
        kind_ok = arr.dtype.kind in "iu" and arr.dtype.itemsize in (1, 2, 4)
        if not kind_ok:
            raise ValueError(f"Unsupported pixel dtype {arr.dtype}; convert to uint8/16/32 or int8/16/32 first")
        self.Rows = rows
        self.Columns = cols
        self.SamplesPerPixel = 1
        self.PhotometricInterpretation = "MONOCHROME2"
        self.BitsAllocated = arr.dtype.itemsize * 8
        self.BitsStored = arr.dtype.itemsize * 8
        self.HighBit = arr.dtype.itemsize * 8 - 1
        self.PixelRepresentation = 1 if arr.dtype.kind == "i" else 0
        self.set_raw(0x7FE0, 0x0010, "OB" if arr.dtype.itemsize == 1 else "OW",
                     arr.astype(arr.dtype.newbyteorder("<")).tobytes())
        object.__setattr__(self, "_pixel_array", None)

    def __repr__(self) -> str:  # pragma: no cover
        return "\n".join(repr(e) for e in self)


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------
class _Parser:
    def __init__(self, buf: bytes, explicit: bool, big_endian: bool = False):
        self.buf = buf
        self.pos = 0
        self.explicit = explicit
        self.e = ">" if big_endian else "<"

    def u16(self) -> int:
        v = struct.unpack_from(self.e + "H", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def u32(self) -> int:
        v = struct.unpack_from(self.e + "I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def read_tag(self) -> int:
        g = self.u16()
        el = self.u16()
        return _tag_int(g, el)

    def parse_dataset(self, stop_at: int | None = None, stop_tag: int | None = None) -> Dataset:
        ds = Dataset()
        end = stop_at if stop_at is not None else len(self.buf)
        while self.pos + 8 <= end:
            start = self.pos
            tag = self.read_tag()
            if stop_tag is not None and tag == stop_tag:
                self.u32()  # length (zero)
                break
            if tag == _SEQ_DELIM_TAG or tag == _ITEM_DELIM_TAG:
                self.u32()
                continue
            vr, length = self._read_vr_len(tag)
            if vr == "SQ" or (length == _UNDEFINED and tag != DICT["PixelData"][0]):
                value = self._parse_sequence(length)
                ds.add(DataElement(tag, "SQ", value))
                continue
            if length == _UNDEFINED:
                # encapsulated pixel data — collect fragments
                value = self._parse_fragments()
                ds.add(DataElement(tag, vr, value))
                continue
            raw = self.buf[self.pos:self.pos + length]
            if len(raw) < length:
                raise InvalidDicomError(f"Truncated element at offset {start}")
            self.pos += length
            ds.add(DataElement(tag, vr, self._decode_value(tag, vr, raw)))
        return ds

    def _read_vr_len(self, tag: int) -> tuple[str, int]:
        group = tag >> 16
        if self.explicit or group == 0x0002:
            vr = self.buf[self.pos:self.pos + 2].decode("ascii", "replace")
            self.pos += 2
            if vr in _LONG_VRS:
                self.pos += 2  # reserved
                length = self.u32()
            else:
                length = self.u16()
            return vr, length
        length = self.u32()
        vr = TAG_TO_VR.get(tag, "UN")
        return vr, length

    def _parse_sequence(self, length: int) -> list[Dataset]:
        items: list[Dataset] = []
        seq_end = None if length == _UNDEFINED else self.pos + length
        while True:
            if seq_end is not None and self.pos >= seq_end:
                break
            if self.pos + 8 > len(self.buf):
                break
            tag = self.read_tag()
            item_len = self.u32()
            if tag == _SEQ_DELIM_TAG:
                break
            if tag != _ITEM_TAG:
                raise InvalidDicomError(f"Expected sequence item, got {tag:08X}")
            if item_len == _UNDEFINED:
                items.append(self.parse_dataset(stop_tag=_ITEM_DELIM_TAG))
            else:
                items.append(self.parse_dataset(stop_at=self.pos + item_len))
        return items

    def _parse_fragments(self) -> list[bytes]:
        frags: list[bytes] = []
        while self.pos + 8 <= len(self.buf):
            tag = self.read_tag()
            length = self.u32()
            if tag == _SEQ_DELIM_TAG:
                break
            frags.append(self.buf[self.pos:self.pos + length])
            self.pos += length
        return frags

    def _decode_value(self, tag: int, vr: str, raw: bytes) -> Any:
        if vr in _BINARY_FMT:
            fmt = self.e + _BINARY_FMT[vr]
            size = struct.calcsize(fmt)
            n = len(raw) // size
            if n == 0:
                return None
            vals = [struct.unpack_from(fmt, raw, i * size)[0] for i in range(n)]
            return vals[0] if n == 1 else vals
        if vr == "AT":
            n = len(raw) // 4
            vals = []
            for i in range(n):
                g, el = struct.unpack_from(self.e + "HH", raw, i * 4)
                vals.append(_tag_int(g, el))
            return vals[0] if n == 1 else vals
        if vr in ("DS", "IS"):
            s = raw.decode("ascii", "replace").strip("\x00 ")
            if not s:
                return None
            parts = [p.strip() for p in s.split("\\")]
            conv = (lambda p: float(p)) if vr == "DS" else (lambda p: int(float(p)))
            vals = [conv(p) for p in parts if p]
            return vals[0] if len(vals) == 1 else vals
        if vr in _STRING_VRS:
            s = raw.decode("latin-1", "replace").rstrip("\x00 ")
            if "\\" in s:
                return s.split("\\")
            return s
        return raw  # OB/OW/UN/OF/OD raw bytes


def _find_meta(buf: bytes) -> tuple[int, str]:
    """Locate the start of the main dataset and the transfer syntax."""
    ts = EXPLICIT_VR_LE
    if buf[128:132] == b"DICM":
        parser = _Parser(buf, explicit=True)
        parser.pos = 132
        # group 0002 is always explicit little-endian
        while parser.pos + 8 <= len(buf):
            save = parser.pos
            tag = parser.read_tag()
            if tag >> 16 != 0x0002:
                parser.pos = save
                break
            vr, length = parser._read_vr_len(tag)
            raw = buf[parser.pos:parser.pos + length]
            parser.pos += length
            if tag == DICT["TransferSyntaxUID"][0]:
                ts = raw.decode("ascii", "replace").rstrip("\x00 ")
        return parser.pos, ts
    # No preamble: sniff explicit vs implicit from the first element
    if len(buf) < 8:
        raise InvalidDicomError("File too short to be DICOM")
    vr_bytes = buf[4:6]
    try:
        vr_txt = vr_bytes.decode("ascii")
    except UnicodeDecodeError:
        vr_txt = ""
    known_vrs = _LONG_VRS | _STRING_VRS | set(_BINARY_FMT) | {"AT", "DS", "IS"}
    ts = EXPLICIT_VR_LE if vr_txt in known_vrs else IMPLICIT_VR_LE
    return 0, ts


def dcmread(path: str | Path | bytes | BinaryIO) -> Dataset:
    """Read a DICOM file/bytes/stream into a :class:`Dataset`."""
    if isinstance(path, bytes):
        buf = path
    elif hasattr(path, "read"):
        pos = path.tell() if path.seekable() else None
        buf = path.read()
        if pos is not None:
            path.seek(pos)
    else:
        buf = Path(path).read_bytes()
    start, ts = _find_meta(buf)
    if ts not in _SUPPORTED_TS:
        raise InvalidDicomError(f"Unsupported (compressed?) transfer syntax: {ts}")
    parser = _Parser(buf, explicit=ts != IMPLICIT_VR_LE, big_endian=ts == EXPLICIT_VR_BE)
    parser.pos = start
    ds = parser.parse_dataset()
    meta = Dataset()
    meta.TransferSyntaxUID = ts
    object.__setattr__(ds, "file_meta", meta)
    return ds


def is_dicom(path: str | Path | bytes | BinaryIO) -> bool:
    """Quick check that a file is a readable DICOM file (preamble or parseable)."""
    try:
        if isinstance(path, (str, Path)):
            if not os.path.isfile(path):
                return False
            with open(path, "rb") as f:
                head = f.read(132)
            if head[128:132] == b"DICM":
                return True
            dcmread(path)
            return True
        dcmread(path)
        return True
    except Exception:
        return False


def is_dicom_image(path: str | Path | bytes | BinaryIO) -> bool:
    """Whether the file is a DICOM file containing an image (PixelData present).

    Mirrors the semantics of the reference ``core/io.py:48``."""
    try:
        ds = dcmread(path)
        return DICT["PixelData"][0] in ds.elements()
    except Exception:
        return False


# --------------------------------------------------------------------------
# Writer (explicit VR little-endian)
# --------------------------------------------------------------------------
def _encode_value(vr: str, value: Any) -> bytes:
    if value is None:
        return b""
    if vr in _BINARY_FMT:
        fmt = "<" + _BINARY_FMT[vr]
        vals = value if isinstance(value, (list, tuple, np.ndarray)) else [value]
        return b"".join(struct.pack(fmt, _num(v, vr)) for v in vals)
    if vr == "AT":
        vals = value if isinstance(value, (list, tuple)) else [value]
        return b"".join(struct.pack("<HH", v >> 16, v & 0xFFFF) for v in vals)
    if vr == "DS":
        vals = value if isinstance(value, (list, tuple, np.ndarray)) else [value]
        s = "\\".join(_format_ds(v) for v in vals)
        return _pad_str(s.encode("ascii"))
    if vr == "IS":
        vals = value if isinstance(value, (list, tuple, np.ndarray)) else [value]
        s = "\\".join(str(int(v)) for v in vals)
        return _pad_str(s.encode("ascii"))
    if vr in _STRING_VRS:
        if isinstance(value, (list, tuple)):
            s = "\\".join(str(v) for v in value)
        else:
            s = str(value)
        pad = b"\x00" if vr == "UI" else b" "
        enc = s.encode("latin-1")
        return enc + pad if len(enc) % 2 else enc
    if isinstance(value, bytes):
        return value + b"\x00" if len(value) % 2 else value
    raise ValueError(f"Cannot encode VR {vr} value {value!r}")


def _num(v: Any, vr: str) -> Any:
    if vr in ("FL", "FD"):
        return float(v)
    return int(v)


def _format_ds(v: Any) -> str:
    s = f"{float(v):.10g}"
    if len(s) > 16:
        s = f"{float(v):.8g}"
    return s


def _pad_str(b: bytes) -> bytes:
    return b + b" " if len(b) % 2 else b


def _write_element(out: io.BytesIO, tag: int, vr: str, value: Any) -> None:
    if vr == "SQ":
        body = io.BytesIO()
        for item in value:
            item_body = _serialize_dataset(item)
            body.write(struct.pack("<HHI", 0xFFFE, 0xE000, len(item_body)))
            body.write(item_body)
        payload = body.getvalue()
        out.write(struct.pack("<HH", tag >> 16, tag & 0xFFFF))
        out.write(b"SQ\x00\x00")
        out.write(struct.pack("<I", len(payload)))
        out.write(payload)
        return
    payload = _encode_value(vr, value)
    out.write(struct.pack("<HH", tag >> 16, tag & 0xFFFF))
    if vr in _LONG_VRS:
        out.write(vr.encode("ascii") + b"\x00\x00")
        out.write(struct.pack("<I", len(payload)))
    else:
        out.write(vr.encode("ascii"))
        out.write(struct.pack("<H", len(payload)))
    out.write(payload)


def _serialize_dataset(ds: Dataset) -> bytes:
    out = io.BytesIO()
    for el in ds:
        if el.tag >> 16 == 0x0002:
            continue
        _write_element(out, el.tag, el.vr, el.value)
    return out.getvalue()


def dcmwrite(path: str | Path | BinaryIO, ds: Dataset,
             transfer_syntax: str = EXPLICIT_VR_LE) -> None:
    """Write a dataset as a DICOM Part-10 file in explicit-VR little-endian
    (the only transfer syntax the port writes)."""
    if transfer_syntax != EXPLICIT_VR_LE:
        raise ValueError(f"dcmwrite cannot encode transfer syntax {transfer_syntax}")
    body = _serialize_dataset(ds)
    meta = io.BytesIO()
    sop_class = ds.get("SOPClassUID", "1.2.840.10008.5.1.4.1.1.7")  # Secondary Capture
    sop_inst = ds.get("SOPInstanceUID", generate_uid())
    _write_element(meta, DICT["FileMetaInformationVersion"][0], "OB", b"\x00\x01")
    _write_element(meta, DICT["MediaStorageSOPClassUID"][0], "UI", sop_class)
    _write_element(meta, DICT["MediaStorageSOPInstanceUID"][0], "UI", sop_inst)
    _write_element(meta, DICT["TransferSyntaxUID"][0], "UI", transfer_syntax)
    _write_element(meta, DICT["ImplementationClassUID"][0], "UI", "2.25.4242424242")
    meta_bytes = meta.getvalue()

    out = io.BytesIO()
    out.write(b"\x00" * 128)
    out.write(b"DICM")
    _write_element(out, DICT["FileMetaInformationGroupLength"][0], "UL", len(meta_bytes))
    out.write(meta_bytes)
    out.write(body)
    data = out.getvalue()
    if hasattr(path, "write"):
        path.write(data)
    else:
        Path(path).write_bytes(data)
