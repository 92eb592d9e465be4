"""EPID simulators: AS500/AS1000/AS1200 detector geometries, numpy only.

Port of ``pylinac_tpu/imggen/simulators.py`` (``Simulator`` ``:15``, with
``plot`` ``:44``, which imports matplotlib inside,
``AS500Image`` ``:54``, ``AS1000Image`` ``:61``, ``AS1200Image`` ``:68``).
"""

from __future__ import annotations

from abc import ABC

import numpy as np

from ..core import dcm
from ..core.array_utils import array_to_dicom
from .layers import Layer


class Simulator(ABC):
    """Layered synthetic EPID image builder."""

    pixel_size: float
    shape: tuple[int, int]

    def __init__(self, sid: float = 1500):
        self.image = np.zeros(self.shape, np.uint16)
        self.sid = sid
        self.mag_factor = sid / 1000

    def add_layer(self, layer: Layer) -> None:
        self.image = layer.apply(self.image, self.pixel_size, self.mag_factor)

    def as_dicom(self, gantry_angle: float = 0.0, coll_angle: float = 0.0,
                 table_angle: float = 0.0, invert_array: bool = False,
                 tags: dict | None = None) -> dcm.Dataset:
        if invert_array:
            array = -self.image + self.image.max() + self.image.min()
        else:
            array = self.image
        return array_to_dicom(
            array=array, sid=self.sid, gantry=gantry_angle, coll=coll_angle,
            couch=table_angle, dpi=25.4 / self.pixel_size, extra_tags=tags or {})

    def generate_dicom(self, file_out_name: str, *args, **kwargs) -> None:
        dcm.dcmwrite(file_out_name, self.as_dicom(*args, **kwargs))

    def plot(self, show: bool = True):
        """The image drawn in grey on a new figure; its axes."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.imshow(self.image, cmap="gray")
        if show:
            plt.show()
        return ax


class AS500Image(Simulator):
    """AS500 EPID: 0.78125 mm pixels, 384×512."""

    pixel_size = 0.78125
    shape = (384, 512)


class AS1000Image(Simulator):
    """AS1000 EPID: 0.390625 mm pixels, 768×1024."""

    pixel_size = 0.390625
    shape = (768, 1024)


class AS1200Image(Simulator):
    """AS1200 EPID: 0.336 mm pixels, 1280×1280."""

    pixel_size = 0.336
    shape = (1280, 1280)
