"""Absolute dose calibration, the port of ``pylinac_tpu/calibration/``."""

from . import tg51, trs398

__all__ = ["tg51", "trs398"]
