"""RT plan generation: QA plans from a template plan.

Port of ``pylinac_tpu/plan_generator/dicom.py``: the enums and
``OvertravelError`` (``:28-64``), the MLC boundary tables (``:51-60``;
the HD120's corrected),
``_Beam``, ``TrueBeamBeam`` and ``HalcyonBeam`` (``:67-273``),
``PlanGenerator`` (``:276``), ``TrueBeamPlanGenerator`` (``:410``: picket
fence, MLC transmission, dose rate, MLC speed, Winston-Lutz, gantry speed
and open-field beams) and ``HalcyonPlanGenerator`` (``:804``: the
dual-stack picket fence). Plans are the port's own ``core/dcm.py``
datasets and files, byte-equal to JAX's for the same UIDs and clock.
``to_dicom_images`` (``:388``) renders each beam's fluence on ``device``
(:func:`.fluence.generate_fluences`) into a simulated EPID frame on the
host, and ``plot_fluences`` (``:383``) draws those maps, one figure a beam
(:func:`.fluence.plot_fluences`).
"""

from __future__ import annotations

import datetime
import math
from abc import ABC, abstractmethod
from copy import deepcopy
from enum import Enum
from pathlib import Path
from typing import Iterable, Literal

import numpy as np

from ..core import dcm, scale
from ..core.dcm import Dataset, generate_uid
from .fluence import generate_fluences, plot_fluences
from .mlc import MLCShaper


class GantryDirection(Enum):
    CLOCKWISE = "CW"
    COUNTER_CLOCKWISE = "CC"
    NONE = "NONE"


class GantrySpeedTransition(Enum):
    LEADING = "leading"
    TRAILING = "trailing"


class FluenceMode(Enum):
    STANDARD = "STANDARD"
    FFF = "FFF"
    SRS = "SRS"


class Stack(Enum):
    DISTAL = "distal"
    PROXIMAL = "proximal"
    BOTH = "both"


MLC_MILLENNIUM_BOUNDARIES = (
    list(np.arange(-200, -100 + 1, 10))
    + list(np.arange(-95, 95 + 1, 5))
    + list(np.arange(100, 200 + 1, 10)))
# the HD120's 60 pairs: 14 of 5 mm, 32 of 2.5 mm, 14 of 5 mm. JAX's list
# steps 10 mm over the top 70 mm (54 boundaries, 53 pairs against the
# beam's 60), so its HD plans have no fluence (ROADMAP section 3).
MLC_120HDMIL_BOUNDARIES = (
    list(np.arange(-110, -40 + 1, 5))
    + list(np.arange(-37.5, 37.5 + 1, 2.5))
    + list(np.arange(40, 110 + 1, 5)))
MLC_DISTAL_BOUNDARIES = list(np.arange(-140, 140 + 1, 10))
MLC_PROXIMAL_BOUNDARIES = list(np.arange(-145, 145 + 1, 10))


class OvertravelError(ValueError):
    pass


class _Beam(ABC):
    """A DICOM BeamSequence item under construction."""

    ROUNDING_DECIMALS = 6

    def __init__(self, beam_limiting_device_sequence: list, beam_name: str,
                 energy: float, fluence_mode: FluenceMode, dose_rate: int,
                 metersets: list[float], gantry_angles, coll_angle: float,
                 beam_limiting_device_positions: dict[str, list],
                 couch_vrt: float, couch_lat: float, couch_lng: float,
                 couch_rot: float):
        number_of_control_points = len(metersets)
        # meterset weights are cumulative fractions of the beam meterset
        metersets_weights = np.array(metersets) / metersets[-1]
        self.meterset = float(np.round(metersets[-1], self.ROUNDING_DECIMALS))

        if len(beam_name) > 16:
            raise ValueError(
                "Beam name must be less than or equal to 16 characters")
        if not isinstance(gantry_angles, Iterable):
            gantry_angles = [gantry_angles] * number_of_control_points

        # round dynamic elements so static-axis detection is exact
        metersets_weights = np.round(metersets_weights, self.ROUNDING_DECIMALS)
        gantry_angles = np.round(gantry_angles, self.ROUNDING_DECIMALS)
        bld_positions = {k: np.round(v, self.ROUNDING_DECIMALS)
                         for k, v in beam_limiting_device_positions.items()}

        # infer gantry direction; assumes no rotation through 180
        ga_wrap180 = scale.wrap180(np.array(gantry_angles))
        direction_map = {0: GantryDirection.NONE,
                         1: GantryDirection.CLOCKWISE,
                         -1: GantryDirection.COUNTER_CLOCKWISE}
        gantry_direction = [direction_map[s]
                            for s in np.sign(np.diff(ga_wrap180))]
        gantry_direction += [GantryDirection.NONE]

        gantry_is_static = len(set(gantry_direction)) == 1
        dict_bld_is_static = {k: bool(np.all(pos == pos[0]))
                              for k, pos in bld_positions.items()}
        blds_are_static = all(dict_bld_is_static.values())
        beam_type = ("STATIC" if gantry_is_static and blds_are_static
                     else "DYNAMIC")

        self.ds = self._create_basic_beam_info(
            beam_name, beam_type, fluence_mode,
            beam_limiting_device_sequence=beam_limiting_device_sequence,
            number_of_control_points=number_of_control_points)

        # initial control point carries the full machine state
        cp0 = Dataset()
        cp0.ControlPointIndex = 0
        cp0.NominalBeamEnergy = energy
        cp0.DoseRateSet = dose_rate
        bldp_seq = []
        for key, values in bld_positions.items():
            bldp = Dataset()
            bldp.RTBeamLimitingDeviceType = key
            bldp.LeafJawPositions = [float(v) for v in values[0]]
            bldp_seq.append(bldp)
        cp0.BeamLimitingDevicePositionSequence = bldp_seq
        cp0.GantryAngle = float(gantry_angles[0])
        cp0.GantryRotationDirection = gantry_direction[0].value
        cp0.BeamLimitingDeviceAngle = coll_angle
        cp0.BeamLimitingDeviceRotationDirection = "NONE"
        cp0.PatientSupportAngle = couch_rot
        cp0.PatientSupportRotationDirection = "NONE"
        cp0.TableTopEccentricAngle = 0.0
        cp0.TableTopEccentricRotationDirection = "NONE"
        cp0.TableTopVerticalPosition = couch_vrt
        cp0.TableTopLongitudinalPosition = couch_lng
        cp0.TableTopLateralPosition = couch_lat
        cp0.CumulativeMetersetWeight = 0.0
        self.ds.ControlPointSequence.append(cp0)

        # subsequent control points carry only the dynamic axes
        for cp_idx in range(1, number_of_control_points):
            cp = Dataset()
            cp.ControlPointIndex = cp_idx
            cp.CumulativeMetersetWeight = float(metersets_weights[cp_idx])
            if not gantry_is_static:
                cp.GantryAngle = float(gantry_angles[cp_idx])
                cp.GantryRotationDirection = gantry_direction[cp_idx].value
            bldp_seq = []
            for bld, positions in bld_positions.items():
                if not dict_bld_is_static[bld]:
                    bldp = Dataset()
                    bldp.RTBeamLimitingDeviceType = bld
                    bldp.LeafJawPositions = [float(v) for v in positions[cp_idx]]
                    bldp_seq.append(bldp)
            if bldp_seq:
                cp.BeamLimitingDevicePositionSequence = bldp_seq
            self.ds.ControlPointSequence.append(cp)

    def as_dicom(self) -> Dataset:
        return self.ds

    @staticmethod
    def _create_basic_beam_info(beam_name: str, beam_type: str,
                                fluence_mode: FluenceMode,
                                beam_limiting_device_sequence: list,
                                number_of_control_points: int) -> Dataset:
        beam = Dataset()
        beam.Manufacturer = "pylinac-tpu"
        beam.PrimaryDosimeterUnit = "MU"
        beam.SourceAxisDistance = 1000.0
        fluence = Dataset()
        if fluence_mode == FluenceMode.STANDARD:
            fluence.FluenceMode = "STANDARD"
        elif fluence_mode == FluenceMode.FFF:
            fluence.FluenceMode = "NON_STANDARD"
            fluence.FluenceModeID = "FFF"
        elif fluence_mode == FluenceMode.SRS:
            fluence.FluenceMode = "NON_STANDARD"
            fluence.FluenceModeID = "SRS"
        beam.PrimaryFluenceModeSequence = [fluence]
        beam.BeamLimitingDeviceSequence = beam_limiting_device_sequence
        beam.BeamName = beam_name
        beam.BeamType = beam_type
        beam.RadiationType = "PHOTON"
        beam.TreatmentDeliveryType = "TREATMENT"
        beam.NumberOfWedges = 0
        beam.NumberOfCompensators = 0
        beam.NumberOfBoli = 0
        beam.NumberOfBlocks = 0
        beam.FinalCumulativeMetersetWeight = 1.0
        beam.NumberOfControlPoints = number_of_control_points
        beam.ControlPointSequence = []
        return beam


class TrueBeamBeam(_Beam):
    """TrueBeam beam: X, Y and ASYM jaws and the 120-leaf MLCX."""

    def __init__(self, is_mlc_hd: bool, beam_name: str, energy: float,
                 fluence_mode: FluenceMode, dose_rate: int,
                 metersets: list[float], gantry_angles, x1: float, x2: float,
                 y1: float, y2: float, mlc_positions: list[list[float]],
                 coll_angle: float, couch_vrt: float, couch_lat: float,
                 couch_lng: float, couch_rot: float):
        jaw_x = Dataset()
        jaw_x.RTBeamLimitingDeviceType = "X"
        jaw_x.NumberOfLeafJawPairs = 1
        jaw_y = Dataset()
        jaw_y.RTBeamLimitingDeviceType = "Y"
        jaw_y.NumberOfLeafJawPairs = 1
        jaw_asymx = Dataset()
        jaw_asymx.RTBeamLimitingDeviceType = "ASYMX"
        jaw_asymx.NumberOfLeafJawPairs = 1
        jaw_asymy = Dataset()
        jaw_asymy.RTBeamLimitingDeviceType = "ASYMY"
        jaw_asymy.NumberOfLeafJawPairs = 1
        mlc = Dataset()
        mlc.RTBeamLimitingDeviceType = "MLCX"
        mlc.NumberOfLeafJawPairs = 60
        mlc.LeafPositionBoundaries = (MLC_120HDMIL_BOUNDARIES if is_mlc_hd
                                      else MLC_MILLENNIUM_BOUNDARIES)
        bld_sequence = [jaw_x, jaw_y, jaw_asymx, jaw_asymy, mlc]
        beam_limiting_device_positions = {
            "ASYMX": [[x1, x2]],
            "ASYMY": [[y1, y2]],
            "MLCX": mlc_positions,
        }
        super().__init__(
            beam_limiting_device_sequence=bld_sequence, beam_name=beam_name,
            energy=energy, fluence_mode=fluence_mode, dose_rate=dose_rate,
            metersets=metersets, gantry_angles=gantry_angles,
            beam_limiting_device_positions=beam_limiting_device_positions,
            coll_angle=coll_angle, couch_vrt=couch_vrt, couch_lat=couch_lat,
            couch_lng=couch_lng, couch_rot=couch_rot)


class HalcyonBeam(_Beam):
    """Halcyon beam: dual MLC stacks, no X jaws."""

    def __init__(self, beam_name: str, metersets: list[float], gantry_angles,
                 distal_mlc_positions: list[list[float]],
                 proximal_mlc_positions: list[list[float]], coll_angle: float,
                 couch_vrt: float, couch_lat: float, couch_lng: float):
        jaw_x = Dataset()
        jaw_x.RTBeamLimitingDeviceType = "X"
        jaw_x.NumberOfLeafJawPairs = 1
        jaw_y = Dataset()
        jaw_y.RTBeamLimitingDeviceType = "Y"
        jaw_y.NumberOfLeafJawPairs = 1
        mlc_x1 = Dataset()
        mlc_x1.RTBeamLimitingDeviceType = "MLCX1"
        mlc_x1.NumberOfLeafJawPairs = 28
        mlc_x1.LeafPositionBoundaries = MLC_DISTAL_BOUNDARIES
        mlc_x2 = Dataset()
        mlc_x2.RTBeamLimitingDeviceType = "MLCX2"
        mlc_x2.NumberOfLeafJawPairs = 29
        mlc_x2.LeafPositionBoundaries = MLC_PROXIMAL_BOUNDARIES
        bld_sequence = [jaw_x, jaw_y, mlc_x1, mlc_x2]
        beam_limiting_device_positions = {
            "X": [[-140, 140]],
            "Y": [[-140, 140]],
            "MLCX1": distal_mlc_positions,
            "MLCX2": proximal_mlc_positions,
        }
        super().__init__(
            beam_limiting_device_sequence=bld_sequence, beam_name=beam_name,
            energy=6, fluence_mode=FluenceMode.FFF, dose_rate=600,
            metersets=metersets, gantry_angles=gantry_angles,
            beam_limiting_device_positions=beam_limiting_device_positions,
            coll_angle=coll_angle, couch_vrt=couch_vrt, couch_lat=couch_lat,
            couch_lng=couch_lng, couch_rot=0)


class PlanGenerator(ABC):
    """Generates QA RT plans from a template plan."""

    def __init__(self, ds: Dataset, plan_label: str, plan_name: str,
                 patient_name: str | None, patient_id: str | None,
                 max_mlc_position: float, max_mlc_speed: float,
                 max_gantry_speed: float, max_overtravel_mm: float):
        if ds.get("Modality") != "RTPLAN":
            raise ValueError("File is not an RTPLAN file")
        self.max_overtravel_mm = max_overtravel_mm
        self.max_mlc_position = max_mlc_position
        self.max_mlc_speed = max_mlc_speed
        self.max_gantry_speed = max_gantry_speed
        patient_name = patient_name or ds.get("PatientName")
        if not patient_name:
            raise ValueError(
                "RTPLAN file must have PatientName or pass it via `patient_name`")
        patient_id = patient_id or ds.get("PatientID")
        if not patient_id:
            raise ValueError(
                "RTPLAN file must have PatientID or pass it via `patient_id`")
        if ds.get("ToleranceTableSequence") is None:
            raise ValueError("RTPLAN file must have ToleranceTableSequence")
        if ds.get("BeamSequence") is None:
            raise ValueError(
                "RTPLAN file must have at least one beam in the beam sequence")
        has_mlc_data = any(
            "MLC" in str(bld.RTBeamLimitingDeviceType)
            for bs in ds.BeamSequence
            for bld in bs.BeamLimitingDeviceSequence)
        if not has_mlc_data:
            raise ValueError("RTPLAN file must have MLC data")

        # deep copy: the subclasses read the template's leaf boundaries
        self.ds = deepcopy(ds)
        self.ds.PatientName = patient_name
        self.ds.PatientID = patient_id
        self.ds.RTPlanLabel = plan_label
        self.ds.RTPlanName = plan_name
        now = datetime.datetime.now()
        self.ds.InstanceCreationDate = now.strftime("%Y%m%d")
        self.ds.InstanceCreationTime = now.strftime("%H%M%S")
        self.ds.SOPInstanceUID = generate_uid()

        patient_setup = Dataset()
        patient_setup.PatientPosition = "HFS"
        patient_setup.PatientSetupNumber = 0
        self.ds.PatientSetupSequence = [patient_setup]

        dose_ref1 = Dataset()
        dose_ref1.DoseReferenceNumber = 1
        dose_ref1.DoseReferenceUID = generate_uid()
        dose_ref1.DoseReferenceStructureType = "SITE"
        dose_ref1.DoseReferenceDescription = "PTV"
        dose_ref1.DoseReferenceType = "TARGET"
        dose_ref1.DeliveryMaximumDose = 20.0
        dose_ref1.TargetPrescriptionDose = 40.0
        dose_ref1.TargetMaximumDose = 20.0
        self.ds.DoseReferenceSequence = [dose_ref1]

        frxn_gp1 = Dataset()
        frxn_gp1.FractionGroupNumber = 1
        frxn_gp1.NumberOfFractionsPlanned = 1
        frxn_gp1.NumberOfBeams = 0
        frxn_gp1.NumberOfBrachyApplicationSetups = 0
        frxn_gp1.ReferencedBeamSequence = []
        self.ds.FractionGroupSequence = [frxn_gp1]

        self.ds.BeamSequence = []
        self.machine_name = ds.BeamSequence[0].TreatmentMachineName
        self._validate_machine_type(ds.BeamSequence)

    @classmethod
    def from_rt_plan_file(cls, rt_plan_file: str | Path, **kwargs):
        ds = dcm.dcmread(rt_plan_file)
        return cls(ds, **kwargs)

    @abstractmethod
    def _validate_machine_type(self, beam_sequence):
        pass

    def add_beam(self, beam: HalcyonBeam | TrueBeamBeam):
        """Append a beam + its referenced-beam metadata."""
        beam_dataset = beam.as_dicom()
        beam_dataset.BeamNumber = len(self.ds.BeamSequence) + 1
        beam_dataset.TreatmentMachineName = self.machine_name
        beam_dataset.ReferencedPatientSetupNumber = \
            self.ds.PatientSetupSequence[0].PatientSetupNumber
        beam_dataset.ReferencedToleranceTableNumber = \
            self.ds.ToleranceTableSequence[0].ToleranceTableNumber
        self.ds.BeamSequence.append(beam_dataset)
        fr = self.ds.FractionGroupSequence[0]
        fr.NumberOfBeams = int(fr.NumberOfBeams) + 1
        referenced_beam = Dataset()
        referenced_beam.BeamDose = 1.0
        referenced_beam.BeamMeterset = beam.meterset
        referenced_beam.ReferencedBeamNumber = beam_dataset.BeamNumber
        referenced_beam.ReferencedDoseReferenceUID = \
            self.ds.DoseReferenceSequence[0].DoseReferenceUID
        fr.ReferencedBeamSequence.append(referenced_beam)

    def to_file(self, filename: str | Path) -> None:
        dcm.dcmwrite(filename, self.ds)

    def as_dicom(self) -> Dataset:
        return self.ds

    def plot_fluences(self, width_mm: float = 400, resolution_mm: float = 0.5,
                      dtype=np.uint16, device=None) -> list:
        """One figure a beam of the plan's fluence, made on ``device``
        (``None`` means CUDA)."""
        return plot_fluences(self.as_dicom(), width_mm, resolution_mm, dtype, show=True,
                             device=device)

    def to_dicom_images(self, simulator, invert: bool = True,
                        device=None) -> list[Dataset]:
        """Simulated EPID images of the plan's beams; the fluences
        accumulate on ``device`` (``None`` means CUDA)."""
        from ..imggen.layers import ArrayLayer

        image_ds = []
        fluences = generate_fluences(
            rt_plan=self.as_dicom(),
            width_mm=simulator.shape[1] * simulator.pixel_size,
            resolution_mm=simulator.pixel_size, device=device)
        for beam, fluence in zip(self.ds.BeamSequence, fluences):
            beam_info = beam.ControlPointSequence[0]
            sim = simulator(sid=1000)
            sim.add_layer(ArrayLayer(fluence))
            ds = sim.as_dicom(
                gantry_angle=beam_info.GantryAngle,
                coll_angle=beam_info.BeamLimitingDeviceAngle,
                table_angle=beam_info.PatientSupportAngle,
                invert_array=invert)
            image_ds.append(ds)
        return image_ds


class TrueBeamPlanGenerator(PlanGenerator):
    """QA plan factories for TrueBeam machines."""

    def __init__(self, ds: Dataset, plan_label: str, plan_name: str,
                 patient_name: str | None = None,
                 patient_id: str | None = None,
                 max_mlc_position: float = 200, max_mlc_speed: float = 25,
                 max_gantry_speed: float = 4.8,
                 max_overtravel_mm: float = 140):
        super().__init__(ds, plan_label, plan_name, patient_name, patient_id,
                         max_mlc_position, max_mlc_speed, max_gantry_speed,
                         max_overtravel_mm)
        self._is_mlc_hd = any(
            float(bld.LeafPositionBoundaries[0]) == -110
            for bs in ds.BeamSequence
            for bld in bs.BeamLimitingDeviceSequence
            if str(bld.RTBeamLimitingDeviceType) == "MLCX")
        self._leaf_boundaries = (MLC_120HDMIL_BOUNDARIES if self._is_mlc_hd
                                 else MLC_MILLENNIUM_BOUNDARIES)

    def _validate_machine_type(self, beam_sequence):
        has_valid = any(str(bld.RTBeamLimitingDeviceType) == "MLCX"
                        for bs in beam_sequence
                        for bld in bs.BeamLimitingDeviceSequence)
        if not has_valid:
            raise ValueError(
                "The machine on the template plan does not seem to be a "
                "TrueBeam machine.")

    def _create_mlc(self, sacrifice_gap_mm: float = None,
                    sacrifice_max_move_mm: float = None) -> MLCShaper:
        return MLCShaper(leaf_y_positions=self._leaf_boundaries,
                         max_mlc_position=self.max_mlc_position,
                         sacrifice_gap_mm=sacrifice_gap_mm,
                         sacrifice_max_move_mm=sacrifice_max_move_mm,
                         max_overtravel_mm=self.max_overtravel_mm)

    def add_picketfence_beam(self, strip_width_mm: float = 3,
                             strip_positions_mm=(-45, -30, -15, 0, 15, 30, 45),
                             y1: float = -100, y2: float = 100,
                             fluence_mode=FluenceMode.STANDARD,
                             dose_rate: int = 600, energy: float = 6,
                             gantry_angle: float = 0, coll_angle: float = 0,
                             couch_vrt: float = 0, couch_lng: float = 1000,
                             couch_lat: float = 0, couch_rot: float = 0,
                             mu: int = 200, jaw_padding_mm: float = 10,
                             beam_name: str = "PF",
                             max_sacrificial_move_mm: float = 50):
        x1 = min(strip_positions_mm) - jaw_padding_mm
        x2 = max(strip_positions_mm) + jaw_padding_mm
        max_dist_to_jaw = max(max(abs(pos - x1), abs(pos + x2))
                              for pos in strip_positions_mm)
        if max_dist_to_jaw > self.max_overtravel_mm:
            raise ValueError(
                "Picket fence beam exceeds MLC overtravel limits. Lower "
                "padding, the number of pickets, or the picket spacing.")
        mlc = self._create_mlc(sacrifice_max_move_mm=max_sacrificial_move_mm)
        # starting position 2mm from the first strip so every picket has the
        # same dynamic cadence
        mlc.add_strip(position_mm=strip_positions_mm[0] - 2,
                      strip_width_mm=strip_width_mm, meterset_at_target=0)
        for strip in strip_positions_mm:
            mlc.add_strip(position_mm=strip, strip_width_mm=strip_width_mm,
                          meterset_at_target=1 / len(strip_positions_mm))
        beam = TrueBeamBeam(
            beam_name=beam_name, energy=energy, dose_rate=dose_rate,
            x1=x1, x2=x2, y1=y1, y2=y2, gantry_angles=gantry_angle,
            coll_angle=coll_angle, couch_vrt=couch_vrt, couch_lat=couch_lat,
            couch_lng=couch_lng, couch_rot=couch_rot,
            mlc_positions=mlc.as_control_points(),
            metersets=[mu * m for m in mlc.as_metersets()],
            fluence_mode=fluence_mode, is_mlc_hd=self._is_mlc_hd)
        self.add_beam(beam)

    def add_mlc_transmission(self, bank: Literal["A", "B"], mu: int = 50,
                             overreach: float = 10, beam_name: str = "MLC Tx",
                             energy: int = 6, dose_rate: int = 600,
                             x1: float = -50, x2: float = 50,
                             y1: float = -100, y2: float = 100,
                             gantry_angle: float = 0, coll_angle: float = 0,
                             couch_vrt: float = 0, couch_lat: float = 0,
                             couch_lng: float = 1000, couch_rot: float = 0,
                             fluence_mode=FluenceMode.STANDARD):
        mlc = self._create_mlc()
        if bank == "A":
            mlc_tips = x2 + overreach
        elif bank == "B":
            mlc_tips = x1 - overreach
        else:
            raise ValueError("Bank must be 'A' or 'B'")
        if abs(x2 - x1) + overreach > self.max_overtravel_mm:
            raise OvertravelError(
                "The MLC overtravel is too large for the given jaw positions "
                "and overreach. Reduce the x-jaw opening size and/or "
                "overreach value.")
        mlc.add_strip(position_mm=mlc_tips, strip_width_mm=1,
                      meterset_at_target=1)
        beam = TrueBeamBeam(
            beam_name=f"{beam_name} {bank}", energy=energy,
            dose_rate=dose_rate, x1=x1, x2=x2, y1=y1, y2=y2,
            gantry_angles=gantry_angle, coll_angle=coll_angle,
            couch_vrt=couch_vrt, couch_lat=couch_lat, couch_lng=couch_lng,
            couch_rot=couch_rot, mlc_positions=mlc.as_control_points(),
            metersets=[mu * m for m in mlc.as_metersets()],
            fluence_mode=fluence_mode, is_mlc_hd=self._is_mlc_hd)
        self.add_beam(beam)

    def add_dose_rate_beams(self, dose_rates=(100, 300, 500, 600),
                            default_dose_rate: int = 600,
                            gantry_angle: float = 0, desired_mu: int = 50,
                            energy: float = 6,
                            fluence_mode=FluenceMode.STANDARD,
                            coll_angle: float = 0, couch_vrt: float = 0,
                            couch_lat: float = 0, couch_lng: float = 1000,
                            couch_rot: float = 0, jaw_padding_mm: float = 5,
                            roi_size_mm: float = 25, y1: float = -100,
                            y2: float = 100,
                            max_sacrificial_move_mm: float = 50):
        if roi_size_mm * len(dose_rates) > self.max_overtravel_mm:
            raise ValueError(
                "The ROI size * number of dose rates must be less than the "
                "overall MLC allowable width")
        mlc_transition_time = roi_size_mm / self.max_mlc_speed
        min_mu = mlc_transition_time * max(dose_rates) * len(dose_rates) / 60
        mu = max(desired_mu, math.ceil(min_mu))
        times_to_transition = [mu * 60 / (dr * len(dose_rates))
                               for dr in dose_rates]
        sacrificial_movements = [tt * self.max_mlc_speed
                                 for tt in times_to_transition]
        mlc = self._create_mlc(sacrifice_max_move_mm=max_sacrificial_move_mm)
        ref_mlc = self._create_mlc()
        roi_centers = np.linspace(
            -roi_size_mm * len(dose_rates) / 2 + roi_size_mm / 2,
            roi_size_mm * len(dose_rates) / 2 - roi_size_mm / 2,
            len(dose_rates))
        ref_mlc.add_strip(position_mm=float(roi_centers[0] - roi_size_mm / 2),
                          strip_width_mm=0, meterset_at_target=0)
        mlc.add_strip(position_mm=float(roi_centers[0] - roi_size_mm / 2),
                      strip_width_mm=0, meterset_at_target=0,
                      initial_sacrificial_gap_mm=5)
        for sacrifice_distance, center in zip(sacrificial_movements,
                                              roi_centers):
            ref_mlc.add_rectangle(
                left_position=center - roi_size_mm / 2,
                right_position=center + roi_size_mm / 2,
                x_outfield_position=-200,
                top_position=max(self._leaf_boundaries),
                bottom_position=min(self._leaf_boundaries),
                outer_strip_width=5, meterset_at_target=0,
                meterset_transition=0.5 / len(dose_rates),
                sacrificial_distance=0)
            ref_mlc.add_strip(position_mm=center + roi_size_mm / 2,
                              strip_width_mm=0, meterset_at_target=0,
                              meterset_transition=0.5 / len(dose_rates),
                              sacrificial_distance_mm=0)
            mlc.add_rectangle(
                left_position=center - roi_size_mm / 2,
                right_position=center + roi_size_mm / 2,
                x_outfield_position=-200,
                top_position=max(self._leaf_boundaries),
                bottom_position=min(self._leaf_boundaries),
                outer_strip_width=5, meterset_at_target=0,
                meterset_transition=0.5 / len(dose_rates),
                sacrificial_distance=sacrifice_distance)
            mlc.add_strip(position_mm=center + roi_size_mm / 2,
                          strip_width_mm=0, meterset_at_target=0,
                          meterset_transition=0.5 / len(dose_rates),
                          sacrificial_distance_mm=sacrifice_distance)
        common = dict(
            energy=energy, dose_rate=default_dose_rate,
            x1=float(roi_centers[0] - roi_size_mm / 2 - jaw_padding_mm),
            x2=float(roi_centers[-1] + roi_size_mm / 2 + jaw_padding_mm),
            y1=y1, y2=y2, gantry_angles=gantry_angle, coll_angle=coll_angle,
            couch_vrt=couch_vrt, couch_lat=couch_lat, couch_lng=couch_lng,
            couch_rot=couch_rot, fluence_mode=fluence_mode,
            is_mlc_hd=self._is_mlc_hd)
        self.add_beam(TrueBeamBeam(
            beam_name="DR Ref", mlc_positions=ref_mlc.as_control_points(),
            metersets=[mu * m for m in ref_mlc.as_metersets()], **common))
        self.add_beam(TrueBeamBeam(
            beam_name=f"DR{min(dose_rates)}-{max(dose_rates)}",
            mlc_positions=mlc.as_control_points(),
            metersets=[mu * m for m in mlc.as_metersets()], **common))

    def add_mlc_speed_beams(self, speeds=(5, 10, 15, 20),
                            roi_size_mm: float = 20, mu: int = 50,
                            default_dose_rate: int = 600,
                            gantry_angle: float = 0, energy: float = 6,
                            coll_angle: float = 0, couch_vrt: float = 0,
                            couch_lat: float = 0, couch_lng: float = 1000,
                            couch_rot: float = 0,
                            fluence_mode=FluenceMode.STANDARD,
                            jaw_padding_mm: float = 5, y1: float = -100,
                            y2: float = 100, beam_name: str = "MLC Speed",
                            max_sacrificial_move_mm: float = 50):
        if max(speeds) > self.max_mlc_speed:
            raise ValueError(
                f"Maximum speed given {max(speeds)} is greater than the "
                f"maximum MLC speed {self.max_mlc_speed}")
        if min(speeds) <= 0:
            raise ValueError("Speeds must be greater than 0")
        if roi_size_mm * len(speeds) > self.max_overtravel_mm:
            raise ValueError(
                "The ROI size * number of speeds must be less than the "
                "overall MLC allowable width")
        times_to_transition = [roi_size_mm / speed for speed in speeds]
        sacrificial_movements = [tt * self.max_mlc_speed
                                 for tt in times_to_transition]
        mlc = self._create_mlc(sacrifice_max_move_mm=max_sacrificial_move_mm)
        ref_mlc = self._create_mlc()
        roi_centers = np.linspace(
            -roi_size_mm * len(speeds) / 2 + roi_size_mm / 2,
            roi_size_mm * len(speeds) / 2 - roi_size_mm / 2, len(speeds))
        ref_mlc.add_strip(position_mm=float(roi_centers[0] - roi_size_mm / 2),
                          strip_width_mm=0, meterset_at_target=0)
        mlc.add_strip(position_mm=float(roi_centers[0] - roi_size_mm / 2),
                      strip_width_mm=0, meterset_at_target=0,
                      initial_sacrificial_gap_mm=5)
        for sacrifice_distance, center in zip(sacrificial_movements,
                                              roi_centers):
            ref_mlc.add_rectangle(
                left_position=center - roi_size_mm / 2,
                right_position=center + roi_size_mm / 2,
                x_outfield_position=-200,
                top_position=max(self._leaf_boundaries),
                bottom_position=min(self._leaf_boundaries),
                outer_strip_width=5, meterset_at_target=0,
                meterset_transition=0.5 / len(speeds))
            ref_mlc.add_strip(position_mm=center + roi_size_mm / 2,
                              strip_width_mm=0, meterset_at_target=0,
                              meterset_transition=0.5 / len(speeds))
            mlc.add_rectangle(
                left_position=center - roi_size_mm / 2,
                right_position=center + roi_size_mm / 2,
                x_outfield_position=-200,
                top_position=max(self._leaf_boundaries),
                bottom_position=min(self._leaf_boundaries),
                outer_strip_width=5, meterset_at_target=0,
                meterset_transition=0.5 / len(speeds),
                sacrificial_distance=sacrifice_distance)
            mlc.add_strip(position_mm=center + roi_size_mm / 2,
                          strip_width_mm=0, meterset_at_target=0,
                          meterset_transition=0.5 / len(speeds),
                          sacrificial_distance_mm=sacrifice_distance)
        common = dict(
            energy=energy, dose_rate=default_dose_rate,
            x1=float(roi_centers[0] - roi_size_mm / 2 - jaw_padding_mm),
            x2=float(roi_centers[-1] + roi_size_mm / 2 + jaw_padding_mm),
            y1=y1, y2=y2, gantry_angles=gantry_angle, coll_angle=coll_angle,
            couch_vrt=couch_vrt, couch_lat=couch_lat, couch_lng=couch_lng,
            couch_rot=couch_rot, fluence_mode=fluence_mode,
            is_mlc_hd=self._is_mlc_hd)
        self.add_beam(TrueBeamBeam(
            beam_name=f"{beam_name} Ref",
            mlc_positions=ref_mlc.as_control_points(),
            metersets=[mu * m for m in ref_mlc.as_metersets()], **common))
        self.add_beam(TrueBeamBeam(
            beam_name=beam_name, mlc_positions=mlc.as_control_points(),
            metersets=[mu * m for m in mlc.as_metersets()], **common))

    def add_winston_lutz_beams(self, x1: float = -10, x2: float = 10,
                               y1: float = -10, y2: float = 10,
                               defined_by_mlcs: bool = True,
                               energy: float = 6,
                               fluence_mode=FluenceMode.STANDARD,
                               dose_rate: int = 600,
                               axes_positions: Iterable[dict] = (
                                   {"gantry": 0, "collimator": 0, "couch": 0},),
                               couch_vrt: float = 0, couch_lng: float = 1000,
                               couch_lat: float = 0, mu: int = 10,
                               padding_mm: float = 5):
        for axes in axes_positions:
            if defined_by_mlcs:
                mlc_padding, jaw_padding = 0, padding_mm
            else:
                mlc_padding, jaw_padding = padding_mm, 0
            mlc = self._create_mlc()
            mlc.add_rectangle(
                left_position=x1 - mlc_padding,
                right_position=x2 + mlc_padding,
                top_position=y2 + mlc_padding,
                bottom_position=y1 - mlc_padding,
                outer_strip_width=5, meterset_at_target=1.0,
                x_outfield_position=x1 - mlc_padding - jaw_padding - 20)
            beam_name = (axes.get("name")
                         or f"G{axes['gantry']:g}C{axes['collimator']:g}"
                            f"P{axes['couch']:g}")
            beam = TrueBeamBeam(
                beam_name=beam_name, energy=energy, dose_rate=dose_rate,
                x1=x1 - jaw_padding, x2=x2 + jaw_padding,
                y1=y1 - jaw_padding, y2=y2 + jaw_padding,
                gantry_angles=axes["gantry"], coll_angle=axes["collimator"],
                couch_vrt=couch_vrt, couch_lat=couch_lat, couch_lng=couch_lng,
                couch_rot=axes["couch"],
                mlc_positions=mlc.as_control_points(),
                metersets=[mu * m for m in mlc.as_metersets()],
                fluence_mode=fluence_mode, is_mlc_hd=self._is_mlc_hd)
            self.add_beam(beam)

    def add_gantry_speed_beams(self, speeds=(2, 3, 4, 4.8),
                               max_dose_rate: int = 600,
                               start_gantry_angle: float = 179,
                               energy: float = 6,
                               fluence_mode=FluenceMode.STANDARD,
                               coll_angle: float = 0, couch_vrt: float = 0,
                               couch_lat: float = 0, couch_lng: float = 1000,
                               couch_rot: float = 0, beam_name: str = "GS",
                               gantry_rot_dir=GantryDirection.CLOCKWISE,
                               jaw_padding_mm: float = 5,
                               roi_size_mm: float = 30, y1: float = -100,
                               y2: float = 100, mu: int = 120):
        from ..core.scale import wrap360

        if max(speeds) > self.max_gantry_speed:
            raise ValueError(
                f"Maximum speed given {max(speeds)} is greater than the "
                f"maximum gantry speed {self.max_gantry_speed}")
        if roi_size_mm * len(speeds) > self.max_overtravel_mm:
            raise ValueError(
                "The ROI size * number of speeds must be less than the "
                "overall MLC allowable width")
        gantry_deltas = [speed * mu * 60 / max_dose_rate for speed in speeds]
        gantry_sign = -1 if gantry_rot_dir == GantryDirection.CLOCKWISE else 1
        g_uncorrected = [start_gantry_angle] + (
            start_gantry_angle + gantry_sign * np.cumsum(gantry_deltas)).tolist()
        gantry_angles = [round(wrap360(a), 2) for a in g_uncorrected]
        if sum(gantry_deltas) >= 360:
            raise ValueError(
                "Gantry travel is >360 degrees. Lower the beam MU, use fewer "
                "speeds, or decrease the desired gantry speeds")
        mlc = self._create_mlc()
        ref_mlc = self._create_mlc()
        roi_centers = np.linspace(
            -roi_size_mm * len(speeds) / 2 + roi_size_mm / 2,
            roi_size_mm * len(speeds) / 2 - roi_size_mm / 2, len(speeds))
        ref_mlc.add_strip(position_mm=float(roi_centers[0]),
                          strip_width_mm=roi_size_mm, meterset_at_target=0)
        mlc.add_strip(position_mm=float(roi_centers[0]),
                      strip_width_mm=roi_size_mm, meterset_at_target=0)
        for center, _gantry_angle in zip(roi_centers, gantry_angles):
            ref_mlc.add_strip(position_mm=center, strip_width_mm=roi_size_mm,
                              meterset_at_target=0,
                              meterset_transition=1 / len(speeds))
            mlc.add_strip(position_mm=center, strip_width_mm=roi_size_mm,
                          meterset_at_target=0,
                          meterset_transition=1 / len(speeds))
        common = dict(
            energy=energy, dose_rate=max_dose_rate,
            x1=min(roi_centers) - roi_size_mm - jaw_padding_mm,
            x2=max(roi_centers) + roi_size_mm + jaw_padding_mm,
            y1=y1, y2=y2, coll_angle=coll_angle, couch_vrt=couch_vrt,
            couch_lat=couch_lat, couch_lng=couch_lng, couch_rot=couch_rot,
            fluence_mode=fluence_mode, is_mlc_hd=self._is_mlc_hd)
        self.add_beam(TrueBeamBeam(
            beam_name=beam_name, gantry_angles=gantry_angles,
            mlc_positions=mlc.as_control_points(),
            metersets=[mu * m for m in mlc.as_metersets()], **common))
        self.add_beam(TrueBeamBeam(
            beam_name=f"{beam_name} Ref", gantry_angles=gantry_angles[-1],
            mlc_positions=ref_mlc.as_control_points(),
            metersets=[mu * m for m in ref_mlc.as_metersets()], **common))

    def add_open_field_beam(self, x1: float, x2: float, y1: float, y2: float,
                            defined_by_mlcs: bool = True, energy: float = 6,
                            fluence_mode=FluenceMode.STANDARD,
                            dose_rate: int = 600, gantry_angle: float = 0,
                            coll_angle: float = 0, couch_vrt: float = 0,
                            couch_lng: float = 1000, couch_lat: float = 0,
                            couch_rot: float = 0, mu: int = 200,
                            padding_mm: float = 5, beam_name: str = "Open",
                            outside_strip_width_mm: float = 5):
        if defined_by_mlcs:
            mlc_padding, jaw_padding = 0, padding_mm
        else:
            mlc_padding, jaw_padding = padding_mm, 0
        mlc = self._create_mlc()
        mlc.add_rectangle(
            left_position=x1 - mlc_padding, right_position=x2 + mlc_padding,
            top_position=y2 + mlc_padding, bottom_position=y1 - mlc_padding,
            outer_strip_width=outside_strip_width_mm,
            x_outfield_position=x1 - mlc_padding - jaw_padding - 20,
            meterset_at_target=1.0)
        beam = TrueBeamBeam(
            beam_name=beam_name, energy=energy, dose_rate=dose_rate,
            x1=x1 - jaw_padding, x2=x2 + jaw_padding, y1=y1 - jaw_padding,
            y2=y2 + jaw_padding, gantry_angles=gantry_angle,
            coll_angle=coll_angle, couch_vrt=couch_vrt, couch_lat=couch_lat,
            couch_lng=couch_lng, couch_rot=couch_rot,
            mlc_positions=mlc.as_control_points(),
            metersets=[mu * m for m in mlc.as_metersets()],
            fluence_mode=fluence_mode, is_mlc_hd=self._is_mlc_hd)
        self.add_beam(beam)


class HalcyonPlanGenerator(PlanGenerator):
    """QA plan factories for dual-stack Halcyon machines."""

    _distal_leaf_boundaries = MLC_DISTAL_BOUNDARIES
    _proximal_leaf_boundaries = MLC_PROXIMAL_BOUNDARIES

    def __init__(self, ds: Dataset, plan_label: str, plan_name: str,
                 patient_name: str | None = None,
                 patient_id: str | None = None,
                 max_mlc_position: float = 140, max_mlc_speed: float = 25,
                 max_gantry_speed: float = 4.8,
                 max_overtravel_mm: float = 140):
        super().__init__(ds, plan_label, plan_name, patient_name, patient_id,
                         max_mlc_position, max_mlc_speed, max_gantry_speed,
                         max_overtravel_mm)

    def _validate_machine_type(self, beam_sequence):
        has_valid = any(str(bld.RTBeamLimitingDeviceType) == "MLCX1"
                        for bs in beam_sequence
                        for bld in bs.BeamLimitingDeviceSequence)
        if not has_valid:
            raise ValueError(
                "The machine on the template plan does not seem to be a "
                "Halcyon machine.")

    def _create_mlc(self) -> tuple[MLCShaper, MLCShaper]:
        proximal_mlc = MLCShaper(
            leaf_y_positions=self._proximal_leaf_boundaries,
            max_mlc_position=self.max_mlc_position,
            max_overtravel_mm=self.max_overtravel_mm)
        distal_mlc = MLCShaper(
            leaf_y_positions=self._distal_leaf_boundaries,
            max_mlc_position=self.max_mlc_position,
            max_overtravel_mm=self.max_overtravel_mm)
        return proximal_mlc, distal_mlc

    def add_picketfence_beam(self, stack: Stack, strip_width_mm: float = 3,
                             strip_positions_mm=(-45, -30, -15, 0, 15, 30, 45),
                             gantry_angle: float = 0, coll_angle: float = 0,
                             couch_vrt: float = 0, couch_lng: float = 1000,
                             couch_lat: float = 0, mu: int = 200,
                             beam_name: str = "PF"):
        prox_mlc, dist_mlc = self._create_mlc()
        strip_positions = [strip_positions_mm[0] - 2, *strip_positions_mm]
        metersets = [0, *[1 / len(strip_positions_mm)
                          for _ in strip_positions_mm]]
        for strip, meterset in zip(strip_positions, metersets):
            if stack in (Stack.DISTAL, Stack.BOTH):
                dist_mlc.add_strip(position_mm=strip,
                                   strip_width_mm=strip_width_mm,
                                   meterset_at_target=meterset)
                if stack == Stack.DISTAL:
                    prox_mlc.park(meterset=meterset)
            if stack in (Stack.PROXIMAL, Stack.BOTH):
                prox_mlc.add_strip(position_mm=strip,
                                   strip_width_mm=strip_width_mm,
                                   meterset_at_target=meterset)
                if stack == Stack.PROXIMAL:
                    dist_mlc.park(meterset=meterset)
        beam = HalcyonBeam(
            beam_name=beam_name, gantry_angles=gantry_angle,
            coll_angle=coll_angle, couch_vrt=couch_vrt, couch_lat=couch_lat,
            couch_lng=couch_lng,
            proximal_mlc_positions=prox_mlc.as_control_points(),
            distal_mlc_positions=dist_mlc.as_control_points(),
            metersets=[mu * m for m in prox_mlc.as_metersets()])
        self.add_beam(beam)

    def add_open_field_beam(self, *args, **kwargs):
        raise NotImplementedError(
            "Open field beams are not yet implemented for Halcyon plans")

    def add_dose_rate_beams(self, *args, **kwargs):
        raise NotImplementedError(
            "Dose rate beams are not yet implemented for Halcyon plans")

    def add_mlc_speed_beams(self, *args, **kwargs):
        raise NotImplementedError(
            "MLC speed beams are not yet implemented for Halcyon plans")

    def add_gantry_speed_beams(self, *args, **kwargs):
        raise NotImplementedError(
            "Gantry speed beams are not yet implemented for Halcyon plans")

    def add_winston_lutz_beams(self, *args, **kwargs):
        raise NotImplementedError(
            "Winston-Lutz beams are not yet implemented for Halcyon plans")
