"""Contributed analyses, the port of ``pylinac_tpu/contrib/``."""
