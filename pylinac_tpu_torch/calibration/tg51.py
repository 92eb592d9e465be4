"""TG-51 absolute dose calibration, photons and electrons.

Carried over from ``pylinac_tpu/calibration/tg51.py``: every function
(``:36-171``: the unit conversions, ``p_tp``, ``p_pol``, ``p_ion``,
``d_ref``, ``r_50``, ``kp_r50``, ``pq_gr``, ``m_corrected``, ``pddx`` and
the kQ fits), ``TG51Photon`` (``:234``), ``TG51ElectronLegacy`` (``:305``)
and ``TG51ElectronModern`` (``:380``) with their ``publish_pdf``
(:mod:`..core.pdf`), the bound checks with JAX's messages. Scalar host
math; the kQ coefficients are the published Muir & Rogers fits
(:mod:`._tg51_tables`).
"""

from __future__ import annotations

from abc import abstractmethod
from datetime import datetime

import numpy as np

from ..core.utilities import Structure
from ._tg51_tables import KQ_ELECTRONS, KQ_PHOTONS

MIN_TEMP = 15
MAX_TEMP = 35
MIN_PRESSURE = 90
MAX_PRESSURE = 115
MIN_PION = 1
MAX_PION = 1.05
MIN_PTP = 0.9
MAX_PTP = 1.1
MIN_PELEC = 0.98
MAX_PELEC = 1.02
MIN_PPOL = 0.98
MAX_PPOL = 1.02

LEAD_OPTIONS = {"None": None, "30cm": "30cm", "50cm": "50cm"}


def _verify_bounds(value, bounds, message: str | None = None) -> None:
    lo, hi = bounds
    if not (lo <= value <= hi):
        msg = (message or "Value {:2.2f} out of range").format(float(value))
        raise ValueError(msg)


def mmHg2kPa(mmHg: float) -> float:
    """Convert pressure in mmHg to kPa."""
    return mmHg * 101.33 / 760


def mbar2kPa(mbar: float) -> float:
    """Convert pressure in mbar to kPa."""
    return mbar / 10


def fahrenheit2celsius(f: float) -> float:
    return (f - 32) * 5 / 9


def tpr2010_from_pdd2010(*, pdd2010: float) -> float:
    """TPR20/10 from PDD20/10 (TG-51 addendum eq 3)."""
    _verify_bounds(pdd2010, (0.5, 1))
    return 1.2661 * pdd2010 - 0.0595


def p_tp(*, temp: float, press: float) -> float:
    """Temperature/pressure correction (TG-51 reference: 22°C, 101.33 kPa)."""
    _verify_bounds(temp, (MIN_TEMP, MAX_TEMP),
                   "Temperature {:2.2f} out of range. Did you use Fahrenheit? "
                   "Consider using fahrenheit2celsius()")
    _verify_bounds(press, (MIN_PRESSURE, MAX_PRESSURE),
                   "Pressure {:2.2f} out of range. Did you use kPa? Consider "
                   "using mmHg2kPa() or mbar2kPa()")
    return ((273.2 + temp) / 295.2) * (101.33 / press)


def p_pol(*, m_reference, m_opposite) -> float:
    """Polarity correction."""
    mref_avg = np.mean(m_reference)
    mopp_avg = np.mean(m_opposite)
    polarity = (abs(mref_avg) + abs(mopp_avg)) / abs(2 * mref_avg)
    _verify_bounds(polarity, (MIN_PPOL, MAX_PPOL),
                   "Polarity correction {:2.2f} out of range (+/-2%). Verify inputs")
    return float(polarity)


def p_ion(*, voltage_reference: int, voltage_reduced: int, m_reference, m_reduced) -> float:
    """Ion-collection (recombination) correction."""
    ion = (1 - voltage_reference / voltage_reduced) / (
        np.mean(m_reference) / np.mean(m_reduced)
        - voltage_reference / voltage_reduced)
    _verify_bounds(ion, (MIN_PION, MAX_PION),
                   "Pion {:2.2f} out of range (1.00-1.05). Check inputs or chamber")
    return float(ion)


def d_ref(*, i_50: float) -> float:
    """Electron reference depth dref = 0.6·R50 − 0.1 cm."""
    if i_50 <= 0:
        raise ValueError("i50 should be positive")
    return 0.6 * r_50(i_50=i_50) - 0.1


def r_50(*, i_50: float) -> float:
    """R50 from I50 (TG-51 eq 16/17)."""
    if i_50 <= 0:
        raise ValueError("i50 should be positive")
    if i_50 < 10:
        return 1.029 * i_50 - 0.06
    return 1.59 * i_50 - 0.37


def kp_r50(*, r_50: float) -> float:
    """kR50 for cylindrical chambers (TG-51 eq 19)."""
    _verify_bounds(r_50, (2, 9))
    return 0.9905 + 0.071 * np.exp(-r_50 / 3.67)


def pq_gr(*, m_dref_plus, m_dref) -> float:
    """Gradient correction PQ_gr for cylindrical chambers."""
    return float(np.mean(m_dref_plus) / np.mean(m_dref))


def m_corrected(*, p_ion: float, p_tp: float, p_elec: float, p_pol: float,
                m_reference) -> float:
    """Fully-corrected chamber reading."""
    _verify_bounds(p_ion, (MIN_PION, MAX_PION))
    _verify_bounds(p_tp, (MIN_PTP, MAX_PTP))
    _verify_bounds(p_elec, (MIN_PELEC, MAX_PELEC))
    _verify_bounds(p_pol, (MIN_PPOL, MAX_PPOL))
    return float(p_ion * p_tp * p_elec * p_pol * np.mean(m_reference))


def pddx(*, pdd: float, energy: int, lead_foil: str | None = None) -> float:
    """Photon-only PDD (PDDx) from the measured PDD (TG-51 eqs 13-15)."""
    _verify_bounds(pdd, (62.7, 89.0))
    if lead_foil not in LEAD_OPTIONS.values():
        raise ValueError(f"Invalid lead foil option {lead_foil}")
    if energy < 10:
        return pdd
    if lead_foil is None:
        if pdd <= 75:
            return pdd
        elif 75 < pdd <= 89:
            return 1.267 * pdd - 20
        raise ValueError(f"PDD value of {pdd} was outside the bound of 89%")
    elif lead_foil == LEAD_OPTIONS["50cm"]:
        if pdd < 73:
            return pdd
        return (0.8905 + 0.0015 * pdd) * pdd
    elif lead_foil == LEAD_OPTIONS["30cm"]:
        if pdd < 71:
            return pdd
        return (0.8116 + 0.00264 * pdd) * pdd


def kq_photon_pddx(*, chamber: str, pddx: float) -> float:
    """kQ for cylindrical chambers from PDDx (Muir & Rogers fits)."""
    _verify_bounds(pddx, (63.0, 86.0))
    ch = KQ_PHOTONS[chamber]
    return ch["a"] + ch["b"] * pddx + ch["c"] * (pddx**2)


def kq_photon_tpr(*, chamber: str, tpr: float) -> float:
    """kQ for cylindrical chambers from TPR20/10 (Muir & Rogers fits)."""
    _verify_bounds(tpr, (0.623, 0.805))
    ch = KQ_PHOTONS[chamber]
    return ch["a'"] + ch["b'"] * tpr + ch["c'"] * (tpr**2) + ch["d'"] * (tpr**3)


def kq_electron(*, chamber: str, r_50: float) -> float:
    """kQ for cylindrical chambers in electron beams (Muir & Rogers)."""
    ch = KQ_ELECTRONS[chamber]
    return (ch["a"] + ch["b"] * r_50 ** -ch["c"]) * ch["kQ,ecal"]


class TG51Base(Structure):
    """Shared TG-51 workflow machinery (corrections + corrected readings)."""

    @property
    def p_tp(self) -> float:
        return p_tp(temp=self.temp, press=self.press)

    @property
    def p_ion(self) -> float:
        return p_ion(voltage_reference=self.voltage_reference,
                     voltage_reduced=self.voltage_reduced,
                     m_reference=self.m_reference, m_reduced=self.m_reduced)

    @property
    def p_pol(self) -> float:
        return p_pol(m_reference=self.m_reference, m_opposite=self.m_opposite)

    @property
    def m_corrected(self) -> float:
        return m_corrected(p_ion=self.p_ion, p_tp=self.p_tp, p_elec=self.p_elec,
                           p_pol=self.p_pol, m_reference=self.m_reference)

    @property
    def m_corrected_adjustment(self) -> float | None:
        if self.m_reference_adjusted is not None:
            return m_corrected(p_ion=self.p_ion, p_tp=self.p_tp,
                               p_elec=self.p_elec, p_pol=self.p_pol,
                               m_reference=self.m_reference_adjusted)

    @property
    def output_was_adjusted(self) -> bool:
        return self.m_reference_adjusted is not None

    def _pdf_text_common(self) -> list[str]:
        return [
            "Site Data:",
            f"Institution: {self.institution}",
            f"Performed by: {self.physicist}",
            f"Measurement Date: {self.measurement_date}",
            f"Date of Report: {datetime.now().strftime('%A, %B %d, %Y')}",
            f"Unit: {self.unit}",
            "",
            "Instrumentation:",
            f"Chamber: {self.chamber}",
            f"N_dw: {self.n_dw:.3f}",
            f"Electrometer: {self.electrometer}",
            "",
            "Corrections:",
            f"Ptp: {self.p_tp:.4f}",
            f"Pion: {self.p_ion:.4f}",
            f"Ppol: {self.p_pol:.4f}",
            f"Pelec: {self.p_elec:.4f}",
            f"Corrected reading: {self.m_corrected:.4f}",
        ]

    @abstractmethod
    def publish_pdf(self, *args, **kwargs):
        pass


class TG51Photon(TG51Base):
    """TG-51 photon-beam calibration workflow."""

    def __init__(self, *, institution: str = "", physicist: str = "", unit: str,
                 measurement_date: str = "", temp: float, press: float, chamber: str,
                 n_dw: float, p_elec: float, electrometer: str = "",
                 measured_pdd10: float | None = None, lead_foil: str | None = None,
                 clinical_pdd10: float, energy: int, fff: bool = False,
                 voltage_reference: int, voltage_reduced: int, m_reference,
                 m_opposite, m_reduced, mu: int, tissue_correction: float = 1.0,
                 m_reference_adjusted=None):
        super().__init__(
            temp=temp, press=press, chamber=chamber, n_dw=n_dw, p_elec=p_elec,
            measured_pdd10=measured_pdd10, energy=energy,
            voltage_reference=voltage_reference, voltage_reduced=voltage_reduced,
            m_reference=m_reference, m_opposite=m_opposite, m_reduced=m_reduced,
            clinical_pdd10=clinical_pdd10, mu=mu,
            tissue_correction=tissue_correction, lead_foil=lead_foil,
            electrometer=electrometer, m_reference_adjusted=m_reference_adjusted,
            institution=institution, physicist=physicist, unit=unit,
            measurement_date=measurement_date, fff=fff)

    @property
    def pddx(self) -> float:
        return pddx(pdd=self.measured_pdd10, energy=self.energy,
                    lead_foil=self.lead_foil)

    @property
    def kq(self) -> float:
        return kq_photon_pddx(chamber=self.chamber, pddx=self.pddx)

    @property
    def dose_mu_10(self) -> float:
        """cGy/MU at 10 cm depth."""
        return self.tissue_correction * self.m_corrected * self.kq * self.n_dw / self.mu

    @property
    def dose_mu_dmax(self) -> float:
        return self.dose_mu_10 / (self.clinical_pdd10 / 100)

    @property
    def dose_mu_10_adjusted(self) -> float:
        return (self.tissue_correction * self.m_corrected_adjustment * self.kq
                * self.n_dw / self.mu)

    @property
    def dose_mu_dmax_adjusted(self) -> float:
        return self.dose_mu_10_adjusted / (self.clinical_pdd10 / 100)

    def publish_pdf(self, filename: str, notes=None, open_file: bool = False,
                    metadata: dict | None = None):
        from ..core.pdf import PylinacCanvas

        canvas = PylinacCanvas(
            filename,
            page_title=f"TG-51 Photon Report - {self.unit} {self.energy} MV"
                       f"{' FFF' if self.fff else ''}",
            metadata=metadata)
        text = self._pdf_text_common() + [
            "",
            f"PDDx: {self.pddx:.2f}",
            f"kQ: {self.kq:.4f}",
            f"Dose/MU @ 10cm: {self.dose_mu_10:.4f} cGy/MU",
            f"Dose/MU @ dmax: {self.dose_mu_dmax:.4f} cGy/MU",
        ]
        canvas.add_text(text=text, location=(2, 25.5))
        if notes is not None:
            canvas.add_text(text=notes, location=(2, 4))
        canvas.finish()


class TG51ElectronLegacy(TG51Base):
    """TG-51 (original) electron calibration with PQ_gr gradient correction."""

    def __init__(self, *, institution: str = "", physicist: str = "", unit: str = "",
                 measurement_date: str = "", energy: int = 0, temp: float,
                 press: float, chamber: str, k_ecal: float, n_dw: float,
                 p_elec: float, electrometer: str = "", clinical_pdd: float,
                 voltage_reference: int, voltage_reduced: int, m_reference,
                 m_opposite, m_reduced, m_gradient, i_50: float, mu: int,
                 tissue_correction: float = 1.0, m_reference_adjusted=None):
        super().__init__(
            temp=temp, press=press, chamber=chamber, n_dw=n_dw, p_elec=p_elec,
            voltage_reference=voltage_reference, voltage_reduced=voltage_reduced,
            m_reference=m_reference, m_opposite=m_opposite, m_reduced=m_reduced,
            m_gradient=m_gradient, i_50=i_50, k_ecal=k_ecal,
            clinical_pdd=clinical_pdd, mu=mu, tissue_correction=tissue_correction,
            electrometer=electrometer, m_reference_adjusted=m_reference_adjusted,
            institution=institution, physicist=physicist, unit=unit,
            measurement_date=measurement_date, energy=energy)

    @property
    def r_50(self) -> float:
        return r_50(i_50=self.i_50)

    @property
    def dref(self) -> float:
        return d_ref(i_50=self.i_50)

    @property
    def pq_gr(self) -> float:
        return pq_gr(m_dref_plus=self.m_gradient, m_dref=self.m_reference)

    @property
    def kq(self) -> float:
        return self.k_ecal * kp_r50(r_50=self.r_50)

    @property
    def dose_mu_dref(self) -> float:
        return (self.tissue_correction * self.m_corrected * self.kq
                * self.pq_gr * self.n_dw / self.mu)

    @property
    def dose_mu_dmax(self) -> float:
        return self.dose_mu_dref / (self.clinical_pdd / 100)

    @property
    def dose_mu_dref_adjusted(self) -> float:
        return (self.tissue_correction * self.m_corrected_adjustment * self.kq
                * self.pq_gr * self.n_dw / self.mu)

    @property
    def dose_mu_dmax_adjusted(self) -> float:
        return self.dose_mu_dref_adjusted / (self.clinical_pdd / 100)

    def publish_pdf(self, filename: str, notes=None, open_file: bool = False,
                    metadata: dict | None = None):
        from ..core.pdf import PylinacCanvas

        canvas = PylinacCanvas(filename, page_title="TG-51 Electron Report (Legacy)",
                               metadata=metadata)
        text = self._pdf_text_common() + [
            "",
            f"R50: {self.r_50:.2f} cm",
            f"Dref: {self.dref:.2f} cm",
            f"PQ_gr: {self.pq_gr:.4f}",
            f"kQ: {self.kq:.4f}",
            f"Dose/MU @ dref: {self.dose_mu_dref:.4f} cGy/MU",
            f"Dose/MU @ dmax: {self.dose_mu_dmax:.4f} cGy/MU",
        ]
        canvas.add_text(text=text, location=(2, 25.5))
        if notes is not None:
            canvas.add_text(text=notes, location=(2, 4))
        canvas.finish()


class TG51ElectronModern(TG51Base):
    """Modernized electron calibration (Muir & Rogers kQ, no gradient corr)."""

    def __init__(self, *, institution: str = "", physicist: str = "", unit: str = "",
                 measurement_date: str = "", energy: int = 0, temp: float,
                 press: float, chamber: str, n_dw: float, p_elec: float,
                 electrometer: str = "", clinical_pdd: float,
                 voltage_reference: int, voltage_reduced: int, m_reference,
                 m_opposite, m_reduced, i_50: float, mu: int,
                 tissue_correction: float = 1.0, m_reference_adjusted=None):
        super().__init__(
            temp=temp, press=press, chamber=chamber, n_dw=n_dw, p_elec=p_elec,
            voltage_reference=voltage_reference, voltage_reduced=voltage_reduced,
            m_reference=m_reference, m_opposite=m_opposite, m_reduced=m_reduced,
            i_50=i_50, clinical_pdd=clinical_pdd, mu=mu,
            tissue_correction=tissue_correction, electrometer=electrometer,
            m_reference_adjusted=m_reference_adjusted, institution=institution,
            physicist=physicist, unit=unit, measurement_date=measurement_date,
            energy=energy)

    @property
    def r_50(self) -> float:
        return r_50(i_50=self.i_50)

    @property
    def dref(self) -> float:
        return d_ref(i_50=self.i_50)

    @property
    def kq(self) -> float:
        return kq_electron(chamber=self.chamber, r_50=self.r_50)

    @property
    def dose_mu_dref(self) -> float:
        return (self.tissue_correction * self.m_corrected * self.kq
                * self.n_dw / self.mu)

    @property
    def dose_mu_dmax(self) -> float:
        return self.dose_mu_dref / (self.clinical_pdd / 100)

    @property
    def dose_mu_dref_adjusted(self) -> float:
        return (self.tissue_correction * self.m_corrected_adjustment * self.kq
                * self.n_dw / self.mu)

    @property
    def dose_mu_dmax_adjusted(self) -> float:
        return self.dose_mu_dref_adjusted / (self.clinical_pdd / 100)

    def publish_pdf(self, filename: str, notes=None, open_file: bool = False,
                    metadata: dict | None = None):
        from ..core.pdf import PylinacCanvas

        canvas = PylinacCanvas(filename, page_title="TG-51 Electron Report (Modern)",
                               metadata=metadata)
        text = self._pdf_text_common() + [
            "",
            f"R50: {self.r_50:.2f} cm",
            f"Dref: {self.dref:.2f} cm",
            f"kQ: {self.kq:.4f}",
            f"Dose/MU @ dref: {self.dose_mu_dref:.4f} cGy/MU",
            f"Dose/MU @ dmax: {self.dose_mu_dmax:.4f} cGy/MU",
        ]
        canvas.add_text(text=text, location=(2, 25.5))
        if notes is not None:
            canvas.add_text(text=notes, location=(2, 4))
        canvas.finish()
