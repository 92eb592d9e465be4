"""IAEA TRS-398 absolute dose calibration, photons and electrons.

Carried over from ``pylinac_tpu/calibration/trs398.py``: every function
(``:46-95``: ``k_tp`` with its warning, ``k_s``, the kQ table
interpolations, ``m_corrected``, and TG-51's shared ones under their
TRS-398 names), ``TRS398Photon`` (``:141``) and ``TRS398Electron``
(``:210``) with their ``publish_pdf``, the bound checks with JAX's
messages. Scalar host math.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..core.utilities import Structure
from . import tg51 as _tg51
from ._trs398_tables import (
    KQ_ELECTRON_CHAMBERS,
    KQ_ELECTRON_R50S,
    KQ_PHOTON_CHAMBERS,
    KQ_PHOTON_TPRS,
    V1_V2_FITS,
)

MIN_TEMP = _tg51.MIN_TEMP
MAX_TEMP = _tg51.MAX_TEMP
MIN_PRESSURE = _tg51.MIN_PRESSURE
MAX_PRESSURE = _tg51.MAX_PRESSURE
MIN_PION = _tg51.MIN_PION
MAX_PION = _tg51.MAX_PION
MIN_PTP = _tg51.MIN_PTP
MAX_PTP = _tg51.MAX_PTP
MIN_PELEC = _tg51.MIN_PELEC
MAX_PELEC = _tg51.MAX_PELEC
MIN_PPOL = _tg51.MIN_PPOL
MAX_PPOL = _tg51.MAX_PPOL

# renamed common functions from TG-51
k_pol = _tg51.p_pol
z_ref = _tg51.d_ref
r_50 = _tg51.r_50
mmHg2kPa = _tg51.mmHg2kPa
mbar2kPa = _tg51.mbar2kPa
fahrenheit2celsius = _tg51.fahrenheit2celsius


def k_tp(*, temp: float, press: float, ref_temp: float = 20) -> float:
    """Temperature/pressure correction (TRS-398 reference air temp 20°C)."""
    warnings.warn(
        "In pylinac v3.29 the reference air temperature was changed from 22 to "
        "20°C to match TRS-398 protocol. This changes k_tp values down by 0.7%.",
        UserWarning)
    _tg51._verify_bounds(temp, (MIN_TEMP, MAX_TEMP),
                         "Temperature {:2.2f} out of range.")
    _tg51._verify_bounds(press, (MIN_PRESSURE, MAX_PRESSURE),
                         "Pressure {:2.2f} out of range.")
    return ((273.2 + temp) / (273.2 + ref_temp)) * (101.33 / press)


def _verify_voltage_ratio_is_valid(voltage_ratio: float) -> None:
    if not any(abs(voltage_ratio - t) < 0.001 for t in (2, 2.5, 3, 3.5, 4, 5)):
        raise ValueError(
            "voltage_reference and voltage_reduced are not a valid ratio. "
            "Valid ratios are: 2, 2.5, 3, 3.5, 4, 5")


def k_s(*, voltage_reference: int, voltage_reduced: int, m_reference, m_reduced) -> float:
    """Ion recombination correction via the two-voltage quadratic fit."""
    v_ratio = voltage_reference / voltage_reduced
    _verify_voltage_ratio_is_valid(v_ratio)
    a = V1_V2_FITS[min(V1_V2_FITS, key=lambda k: abs(k - v_ratio))]
    m_ratio = np.mean(m_reference) / np.mean(m_reduced)
    _tg51._verify_bounds(m_ratio, (MIN_PION, MAX_PION),
                         "Ks is out of bounds. Verify inputs or check chamber")
    return float(a["a0"] + a["a1"] * m_ratio + a["a2"] * (m_ratio**2))


def kq_photon(*, chamber: str, tpr: float) -> float:
    """kQ from TPR20/10 (TRS-398 Table 6.III, linear interpolation)."""
    _tg51._verify_bounds(tpr, (KQ_PHOTON_TPRS[0], KQ_PHOTON_TPRS[-1]))
    return float(np.interp(tpr, KQ_PHOTON_TPRS, KQ_PHOTON_CHAMBERS[chamber]))


def kq_electron(*, chamber: str, r_50: float) -> float:
    """kQ from R50 (TRS-398 Table 7.III, linear interpolation)."""
    _tg51._verify_bounds(r_50, (KQ_ELECTRON_R50S[0], KQ_ELECTRON_R50S[-1]))
    return float(np.interp(r_50, KQ_ELECTRON_R50S, KQ_ELECTRON_CHAMBERS[chamber]))


def m_corrected(*, m_reference, k_tp, k_elec, k_pol, k_s) -> float:
    """Fully-corrected chamber reading."""
    _tg51._verify_bounds(k_tp, (MIN_PTP, MAX_PTP))
    _tg51._verify_bounds(k_elec, (MIN_PELEC, MAX_PELEC))
    _tg51._verify_bounds(k_pol, (MIN_PPOL, MAX_PPOL))
    _tg51._verify_bounds(k_s, (MIN_PION, MAX_PION))
    return float(np.mean(m_reference) * k_tp * k_elec * k_pol * k_s)


class TRS398Base(Structure):
    @property
    def k_tp(self) -> float:
        return k_tp(temp=self.temp, press=self.press)

    @property
    def k_pol(self) -> float:
        return k_pol(m_reference=self.m_reference, m_opposite=self.m_opposite)

    @property
    def k_s(self) -> float:
        return k_s(voltage_reference=self.voltage_reference,
                   voltage_reduced=self.voltage_reduced,
                   m_reference=self.m_reference, m_reduced=self.m_reduced)

    @property
    def m_corrected(self) -> float:
        return m_corrected(m_reference=self.m_reference, k_tp=self.k_tp,
                           k_elec=self.k_elec, k_pol=self.k_pol, k_s=self.k_s)

    @property
    def dose_mu_zref(self) -> float:
        """cGy/MU at zref."""
        return (self.tissue_correction * self.m_corrected * self.n_dw
                * self.kq / self.mu)

    @property
    def m_corrected_adjusted(self) -> float | None:
        if self.m_reference_adjusted is not None:
            return m_corrected(m_reference=self.m_reference_adjusted,
                               k_tp=self.k_tp, k_elec=self.k_elec,
                               k_pol=self.k_pol, k_s=self.k_s)

    @property
    def dose_mu_zref_adjusted(self) -> float:
        return (self.tissue_correction * self.m_corrected_adjusted * self.n_dw
                * self.kq / self.mu)

    @property
    def output_was_adjusted(self) -> bool:
        return self.m_reference_adjusted is not None


class TRS398Photon(TRS398Base):
    """TRS-398 photon calibration workflow."""

    def __init__(self, *, institution: str = "", physicist: str = "", unit: str = "",
                 measurement_date: str = "", electrometer: str = "",
                 setup: str, chamber: str, n_dw: float, mu: int,
                 tpr2010: float, energy: int = 6, fff: bool = False,
                 press: float, temp: float, voltage_reference: int,
                 voltage_reduced: int, m_reference, m_opposite, m_reduced,
                 k_elec: float, clinical_pdd_zref: float | None = None,
                 clinical_tmr_zref: float | None = None,
                 tissue_correction: float = 1.0, m_reference_adjusted=None):
        if setup not in ("SSD", "SAD"):
            raise ValueError("setup must be one of 'SSD', 'SAD'")
        _tg51._verify_bounds(tpr2010, (KQ_PHOTON_TPRS[0], KQ_PHOTON_TPRS[-1]))
        super().__init__(
            institution=institution, physicist=physicist, unit=unit,
            measurement_date=measurement_date, electrometer=electrometer,
            setup=setup, chamber=chamber, n_dw=n_dw, mu=mu, tpr2010=tpr2010,
            energy=energy, fff=fff, press=press, temp=temp,
            voltage_reference=voltage_reference, voltage_reduced=voltage_reduced,
            m_reference=m_reference, m_opposite=m_opposite, m_reduced=m_reduced,
            k_elec=k_elec, clinical_pdd_zref=clinical_pdd_zref,
            clinical_tmr_zref=clinical_tmr_zref,
            tissue_correction=tissue_correction,
            m_reference_adjusted=m_reference_adjusted)

    @property
    def kq(self) -> float:
        return kq_photon(chamber=self.chamber, tpr=self.tpr2010)

    @property
    def dose_mu_zmax(self) -> float:
        """SSD setups divide by the clinical PDD; SAD setups by the TMR."""
        if self.setup == "SSD":
            return (100 * self.dose_mu_zref) / self.clinical_pdd_zref
        return self.dose_mu_zref / self.clinical_tmr_zref

    @property
    def dose_mu_zmax_adjusted(self) -> float:
        if self.setup == "SSD":
            return (100 * self.dose_mu_zref_adjusted) / self.clinical_pdd_zref
        return self.dose_mu_zref_adjusted / self.clinical_tmr_zref

    def publish_pdf(self, filename: str, notes=None, open_file: bool = False,
                    metadata: dict | None = None):
        from ..core.pdf import PylinacCanvas

        canvas = PylinacCanvas(
            filename, page_title=f"TRS-398 Photon Report - {self.unit} {self.energy} MV",
            metadata=metadata)
        text = [
            f"Institution: {self.institution}",
            f"Performed by: {self.physicist}",
            f"Unit: {self.unit}",
            f"kQ: {self.kq:.4f}",
            f"k_tp: {self.k_tp:.4f}",
            f"k_s: {self.k_s:.4f}",
            f"k_pol: {self.k_pol:.4f}",
            f"Corrected reading: {self.m_corrected:.4f}",
            f"Dose/MU @ zref: {self.dose_mu_zref:.4f} cGy/MU",
            f"Dose/MU @ zmax: {self.dose_mu_zmax:.4f} cGy/MU",
        ]
        canvas.add_text(text=text, location=(2, 25.5))
        if notes is not None:
            canvas.add_text(text=notes, location=(2, 4))
        canvas.finish()


class TRS398Electron(TRS398Base):
    """TRS-398 electron calibration workflow."""

    def __init__(self, *, institution: str = "", physicist: str = "", unit: str = "",
                 measurement_date: str = "", electrometer: str = "",
                 energy: str | int = "", cone: str = "", chamber: str,
                 n_dw: float, mu: int,
                 i_50: float, press: float, temp: float, voltage_reference: int,
                 voltage_reduced: int, m_reference, m_opposite, m_reduced,
                 k_elec: float, clinical_pdd_zref: float,
                 tissue_correction: float = 1.0, m_reference_adjusted=None):
        super().__init__(
            institution=institution, physicist=physicist, unit=unit,
            measurement_date=measurement_date, electrometer=electrometer,
            energy=energy, cone=cone, chamber=chamber, n_dw=n_dw, mu=mu,
            i_50=i_50,
            press=press, temp=temp, voltage_reference=voltage_reference,
            voltage_reduced=voltage_reduced, m_reference=m_reference,
            m_opposite=m_opposite, m_reduced=m_reduced, k_elec=k_elec,
            clinical_pdd_zref=clinical_pdd_zref,
            tissue_correction=tissue_correction,
            m_reference_adjusted=m_reference_adjusted)

    @property
    def r_50(self) -> float:
        return r_50(i_50=self.i_50)

    @property
    def zref(self) -> float:
        return z_ref(i_50=self.i_50)

    @property
    def kq(self) -> float:
        return kq_electron(chamber=self.chamber, r_50=self.r_50)

    @property
    def dose_mu_zmax(self) -> float:
        return (100 * self.dose_mu_zref) / self.clinical_pdd_zref

    @property
    def dose_mu_zmax_adjusted(self) -> float:
        return (100 * self.dose_mu_zref_adjusted) / self.clinical_pdd_zref

    def publish_pdf(self, filename: str, notes=None, open_file: bool = False,
                    metadata: dict | None = None):
        from ..core.pdf import PylinacCanvas

        canvas = PylinacCanvas(filename, page_title="TRS-398 Electron Report",
                               metadata=metadata)
        text = [
            f"Institution: {self.institution}",
            f"Unit: {self.unit}",
            f"R50: {self.r_50:.2f} cm",
            f"zref: {self.zref:.2f} cm",
            f"kQ: {self.kq:.4f}",
            f"Dose/MU @ zref: {self.dose_mu_zref:.4f} cGy/MU",
            f"Dose/MU @ zmax: {self.dose_mu_zmax:.4f} cGy/MU",
        ]
        canvas.add_text(text=text, location=(2, 25.5))
        if notes is not None:
            canvas.add_text(text=notes, location=(2, 4))
        canvas.finish()
