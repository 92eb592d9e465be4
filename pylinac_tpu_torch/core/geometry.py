"""Host geometry primitives, numpy only.

Port of ``pylinac_tpu/core/geometry.py``: the degree ``cos`` and ``sin``
(``:26-31``), ``direction_to_coords`` ``:34``, ``Point`` ``:44``, ``Vector`` ``:125``, ``Circle`` ``:174``,
``Line`` ``:213`` (with the 3D point distance) and ``Rectangle`` ``:282``,
with their drawing (``:194-368``): ``plot2axes`` draws on a matplotlib axes,
imported by the patch it adds; ``plotly`` raises ``NotImplementedError`` as
in the JAX package. ``tan``, ``atan``, ``vector_is_close`` and ``to_json``
wait for a caller.
"""

from __future__ import annotations

import math
from collections.abc import Iterable

import numpy as np


def cos(degrees: float) -> float:
    return math.cos(math.radians(degrees))


def sin(degrees: float) -> float:
    return math.sin(math.radians(degrees))


def direction_to_coords(start_x: float, start_y: float, distance: float,
                        angle_degrees: float) -> tuple[float, float]:
    """The point ``distance`` from a start along ``angle_degrees`` (0 is
    East, counter-clockwise positive)."""
    x = start_x + distance * cos(angle_degrees)
    y = start_y + distance * sin(angle_degrees)
    return x, y


class Point:
    """A 2D/3D point with an optional value at that point."""

    z: float
    y: float
    x: float
    _attr_list: tuple[str, ...] = ("x", "y", "z", "idx", "value")
    _coord_list: tuple[str, ...] = ("x", "y", "z")

    def __init__(
        self,
        x: float | tuple | Point = 0,
        y: float = 0,
        z: float = 0,
        idx: int | None = None,
        value: float | None = None,
        as_int: bool = False,
    ):
        if isinstance(x, Point):
            idx = x.idx if idx is None else idx
            value = x.value if value is None else value
            x, y, z = x.x, x.y, x.z
        elif isinstance(x, Iterable) and not isinstance(x, str):
            seq = list(x)
            x = seq[0]
            if len(seq) > 1:
                y = seq[1]
            if len(seq) > 2:
                z = seq[2]
        if as_int:
            x, y, z = int(round(x)), int(round(y)), int(round(z))
        else:
            x, y, z = float(x), float(y), float(z)
        self.x = x
        self.y = y
        self.z = z
        self.idx = idx
        self.value = None if value is None else float(value)

    def distance_to(self, thing: Point | Circle) -> float:
        """Distance to another Point or to a Circle edge."""
        if isinstance(thing, Circle):
            return abs(
                math.hypot(self.x - thing.center.x, self.y - thing.center.y)
                - thing.radius
            )
        return math.sqrt(
            (self.x - thing.x) ** 2 + (self.y - thing.y) ** 2 + (self.z - thing.z) ** 2
        )

    def as_array(self, coords: tuple[str, ...] = ("x", "y", "z")) -> np.ndarray:
        return np.array([getattr(self, c) for c in coords], dtype=float)

    def as_vector(self) -> Vector:
        return Vector(self.x, self.y, self.z)

    def dict(self) -> dict:
        return {a: getattr(self, a) for a in self._attr_list}

    def as_dict(self) -> dict:
        return self.dict()

    def __repr__(self) -> str:
        return f"Point(x={self.x:3.2f}, y={self.y:3.2f}, z={self.z:3.2f})"

    def __eq__(self, other) -> bool:
        return self.x == other.x and self.y == other.y and self.z == other.z

    def __add__(self, other) -> Vector:
        return Vector(self.x + other.x, self.y + other.y, self.z + other.z)

    def __sub__(self, other) -> Vector:
        return Vector(self.x - other.x, self.y - other.y, self.z - other.z)

    def __mul__(self, other: float) -> Point:
        return Point(self.x * other, self.y * other, self.z * other)

    def __truediv__(self, other: float) -> Point:
        return Point(self.x / other, self.y / other, self.z / other)


class Vector:
    """A 3D vector."""

    def __init__(self, x: float = 0, y: float = 0, z: float = 0):
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)

    def __repr__(self):
        return f"Vector(x={self.x:.2f}, y={self.y:.2f}, z={self.z:.2f})"

    def as_scalar(self) -> float:
        return math.sqrt(self.x**2 + self.y**2 + self.z**2)

    def as_point(self) -> Point:
        return Point(self.x, self.y, self.z)

    def dict(self) -> dict:
        return {"x": self.x, "y": self.y, "z": self.z}

    def as_dict(self) -> dict:
        return self.dict()

    def distance_to(self, thing: Circle | Point) -> float:
        return self.as_point().distance_to(thing)

    def __sub__(self, other: Vector) -> Vector:
        return Vector(self.x - other.x, self.y - other.y, self.z - other.z)

    def __add__(self, other: Vector) -> Vector:
        return Vector(self.x + other.x, self.y + other.y, self.z + other.z)

    def __neg__(self) -> Vector:
        return Vector(-self.x, -self.y, -self.z)

    def __truediv__(self, other: float) -> Vector:
        return Vector(self.x / other, self.y / other, self.z / other)

    def __eq__(self, other) -> bool:
        return self.x == other.x and self.y == other.y and self.z == other.z


class Circle:
    """A circle with a center Point and a radius."""

    def __init__(self, center_point: Point | Iterable = (0, 0), radius: float = 0):
        if not isinstance(center_point, Point):
            center_point = Point(center_point)
        self.center = center_point
        self.radius = float(radius)

    @property
    def area(self) -> float:
        return math.pi * self.radius**2

    @property
    def diameter(self) -> float:
        return self.radius * 2

    def as_dict(self) -> dict:
        return {"center_x": self.center.x, "center_y": self.center.y, "radius": self.radius}

    def plotly(self, fig, color: str = "cyan", **kwargs) -> None:  # pragma: no cover
        raise NotImplementedError("plotly is not available in this environment")

    def plot2axes(self, axes, edgecolor: str = "black", fill: bool = False, text: str = "",
                  fontsize: str = "medium", **kwargs) -> None:
        from matplotlib.patches import Circle as mpl_Circle

        axes.add_patch(mpl_Circle((self.center.x, self.center.y), edgecolor=edgecolor,
                                  radius=self.radius, fill=fill, **kwargs))
        if text:
            axes.annotate(text, (self.center.x, self.center.y - self.radius), fontsize=fontsize,
                          color=edgecolor)


class Line:
    """A line defined by two points."""

    def __init__(self, point1: Point | tuple, point2: Point | tuple):
        self.point1 = Point(point1)
        self.point2 = Point(point2)

    def __repr__(self) -> str:
        return f"Line: p1:{self.point1!r} p2:{self.point2!r}"

    @property
    def m(self) -> float:
        """Slope (dy/dx)."""
        dx = self.point2.x - self.point1.x
        dy = self.point2.y - self.point1.y
        return dy / dx if dx != 0 else math.inf

    @property
    def b(self) -> float:
        """y-intercept."""
        return self.point1.y - self.m * self.point1.x

    def y(self, x) -> float:
        return self.m * x + self.b

    def x(self, y) -> float:
        return (y - self.b) / self.m

    @property
    def center(self) -> Point:
        return Point(
            (self.point1.x + self.point2.x) / 2,
            (self.point1.y + self.point2.y) / 2,
            (self.point1.z + self.point2.z) / 2,
        )

    @property
    def length(self) -> float:
        return self.point1.distance_to(self.point2)

    def distance_to(self, point: Point) -> float:
        """Minimum (perpendicular) distance of a point to the (infinite) 3D line,
        computed via the cross-product identity |d × (p1-p)| / |d|."""
        p1 = self.point1.as_array()
        p2 = self.point2.as_array()
        p = point.as_array()
        d = p2 - p1
        num = np.linalg.norm(np.cross(d, p1 - p))
        return float(num / np.linalg.norm(d))

    def dict(self) -> dict:
        return {"point1": self.point1.dict(), "point2": self.point2.dict()}

    def as_dict(self) -> dict:
        return self.dict()

    def plot2axes(self, axes, width: float = 1, color: str = "w", label: str | None = None) -> None:
        axes.plot((self.point1.x, self.point2.x), (self.point1.y, self.point2.y),
                  linewidth=width, color=color, label=label)

    def plotly(self, fig, color: str = "blue", **kwargs) -> None:  # pragma: no cover
        raise NotImplementedError("plotly is not available in this environment")


class Rectangle:
    """A rectangle with a center point, width, height and optional rotation (degrees, CW)."""

    def __init__(
        self,
        width: float,
        height: float,
        center: Point | tuple,
        rotation: float = 0.0,
    ):
        if width <= 0:
            raise ValueError("Width must be positive")
        if height <= 0:
            raise ValueError("Height must be positive")
        self.width = float(width)
        self.height = float(height)
        self.rotation = float(rotation)
        self.center = Point(center)

    @property
    def area(self) -> float:
        return self.width * self.height

    @property
    def vertices(self) -> list[Point]:
        """The four corners, rotation-aware, ordered TL, TR, BR, BL
        (in image coordinates where +y is down)."""
        hw, hh = self.width / 2, self.height / 2
        corners = [(-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)]
        rad = math.radians(self.rotation)
        c, s = math.cos(rad), math.sin(rad)
        return [
            Point(
                self.center.x + dx * c - dy * s,
                self.center.y + dx * s + dy * c,
            )
            for dx, dy in corners
        ]

    @property
    def tl_corner(self) -> Point:
        return self.vertices[0]

    @property
    def tr_corner(self) -> Point:
        return self.vertices[1]

    @property
    def br_corner(self) -> Point:
        return self.vertices[2]

    @property
    def bl_corner(self) -> Point:
        return self.vertices[3]

    def as_dict(self) -> dict:
        return {
            "center_x": self.center.x,
            "center_y": self.center.y,
            "width": self.width,
            "height": self.height,
            "rotation": self.rotation,
        }

    def plot2axes(self, axes, edgecolor: str = "black", angle: float | None = None,
                  fill: bool = False, alpha: float = 1, facecolor: str = "g", label=None,
                  text: str = "", fontsize: str = "medium", text_rotation: float = 0, **kwargs):
        from matplotlib.patches import Rectangle as mpl_Rectangle

        angle = self.rotation if angle is None else angle
        bl = self.bl_corner
        axes.add_patch(mpl_Rectangle((bl.x, bl.y), width=self.width, height=self.height,
                                     angle=-angle, edgecolor=edgecolor, alpha=alpha,
                                     facecolor=facecolor, fill=fill, label=label, **kwargs))
        if text:
            axes.annotate(text, (self.center.x, self.center.y), fontsize=fontsize,
                          color=edgecolor, rotation=text_rotation, ha="center")

    def plotly(self, fig, **kwargs) -> None:  # pragma: no cover
        raise NotImplementedError("plotly is not available in this environment")
