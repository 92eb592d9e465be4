"""Host geometry: ``Point``, as far as image centres and results need it.

Port of ``Point`` from ``pylinac_tpu/core/geometry.py:44``: its
coordinates, ``idx`` and ``value``, and ``dict``.
"""

from __future__ import annotations


class Point:
    """A 2D/3D point with an optional value at that point."""

    _attr_list: tuple[str, ...] = ("x", "y", "z", "idx", "value")

    def __init__(self, x: float = 0, y: float = 0, z: float = 0,
                 idx: int | None = None, value: float | None = None):
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)
        self.idx = idx
        self.value = None if value is None else float(value)

    def dict(self) -> dict:
        return {a: getattr(self, a) for a in self._attr_list}

    def __repr__(self) -> str:
        return f"Point(x={self.x:3.2f}, y={self.y:3.2f}, z={self.z:3.2f})"
