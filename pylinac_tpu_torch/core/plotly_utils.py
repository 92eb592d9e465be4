"""Plotly figures as their JSON schema, without the plotly package.

A copy of ``pylinac_tpu/core/plotly_utils.py`` (``:1-205``): a plotly
figure is a dict with ``data`` (trace dicts) and ``layout``, which
:class:`Figure` builds directly, so the figures exist, serialise and export
to HTML where plotly is not installed (the machine with the card has none).
:meth:`Figure.to_plotly` and :meth:`Figure.show` import plotly inside
themselves. The helpers keep the names of the reference's ``add_title``,
``set_axis_range``, ``add_vertical_line`` and ``add_horizontal_line``.
"""

from __future__ import annotations

import json
from typing import Any, Sequence

import numpy as np

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<script src="https://cdn.plot.ly/plotly-2.32.0.min.js"></script></head>
<body><div id="fig" style="width:100%;height:100vh;"></div>
<script>Plotly.newPlot("fig", {data}, {layout});</script>
</body></html>
"""


def _clean(obj: Any):
    """JSON-serializable copy: numpy arrays → lists, numpy scalars → python."""
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class Figure:
    """A plotly figure as its JSON schema (``{"data": [...], "layout": {...}}``)."""

    def __init__(self, data: list[dict] | None = None, layout: dict | None = None):
        self.data: list[dict] = list(data or [])
        self.layout: dict = dict(layout or {})

    # -- plotly-compatible surface ------------------------------------------
    def add_trace(self, trace: dict) -> "Figure":
        self.data.append(dict(trace))
        return self

    def update_layout(self, **kwargs) -> "Figure":
        for key, value in kwargs.items():
            # plotly's magic underscore notation: xaxis_title="t" →
            # layout["xaxis"]["title"] = "t"
            parts = key.split("_")
            tgt = self.layout
            while len(parts) > 1 and parts[0] in (
                    "xaxis", "yaxis", "legend", "title", "margin", "font",
                    "coloraxis", "scene"):
                tgt = tgt.setdefault(parts[0], {})
                parts = parts[1:]
            tgt["_".join(parts)] = value
        return self

    def update_xaxes(self, **kwargs) -> "Figure":
        self.layout.setdefault("xaxis", {}).update(kwargs)
        return self

    def update_yaxes(self, **kwargs) -> "Figure":
        self.layout.setdefault("yaxis", {}).update(kwargs)
        return self

    # -- export --------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"data": _clean(self.data), "layout": _clean(self.layout)}

    def to_json(self, **json_kwargs) -> str:
        return json.dumps(self.to_dict(), **json_kwargs)

    def write_html(self, path) -> None:
        d = self.to_dict()
        with open(path, "w") as f:
            f.write(_HTML_TEMPLATE.format(
                data=json.dumps(d["data"]), layout=json.dumps(d["layout"])))

    def write_json(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def show(self) -> None:  # pragma: no cover - needs a browser/plotly
        try:
            self.to_plotly().show()
        except ImportError:
            import warnings

            warnings.warn(
                "plotly is not installed; use .write_html(path) to view this "
                "figure in a browser, or .to_dict()/.to_json() for the schema.")

    def to_plotly(self):
        """Upgrade to a real ``plotly.graph_objects.Figure`` (requires plotly)."""
        from plotly import graph_objects as go  # noqa: deferred hard dep

        return go.Figure(data=self.to_dict()["data"], layout=self.to_dict()["layout"])


# ===========================================================================
# trace builders
# ===========================================================================
def heatmap_trace(array: np.ndarray, colorscale: str = "Gray",
                  show_colorbar: bool = True, **kwargs) -> dict:
    """An image as a plotly heatmap trace (y axis image-style: reversed)."""
    return {"type": "heatmap", "z": np.asarray(array),
            "colorscale": colorscale, "showscale": show_colorbar, **kwargs}


def scatter_trace(x: Sequence[float], y: Sequence[float], *, name: str | None = None,
                  mode: str = "lines", **kwargs) -> dict:
    return {"type": "scatter", "x": np.asarray(x), "y": np.asarray(y),
            "mode": mode, **({"name": name} if name else {}), **kwargs}


def marker_trace(x: Sequence[float], y: Sequence[float], *, name: str | None = None,
                 symbol: str = "circle", color: str | None = None, size: int = 8,
                 **kwargs) -> dict:
    marker = {"symbol": symbol, "size": size}
    if color:
        marker["color"] = color
    return {"type": "scatter", "x": np.asarray(x), "y": np.asarray(y),
            "mode": "markers", "marker": marker,
            **({"name": name} if name else {}), **kwargs}


def histogram_trace(values: Sequence[float], *, name: str | None = None,
                    nbins: int | None = None, **kwargs) -> dict:
    tr = {"type": "histogram", "x": np.asarray(values), **kwargs}
    if nbins:
        tr["nbinsx"] = nbins
    if name:
        tr["name"] = name
    return tr


def image_figure(array: np.ndarray, *, title: str | None = None,
                 show_colorbar: bool = True, colorscale: str = "Gray",
                 **kwargs) -> Figure:
    """Standard analyzed-image figure: grayscale heatmap, y reversed,
    equal-aspect axes (mirrors reference ``BaseImage.plotly``,
    ``core/image.py:576``)."""
    fig = Figure()
    fig.add_trace(heatmap_trace(array, colorscale=colorscale,
                                show_colorbar=show_colorbar, **kwargs))
    fig.layout["yaxis"] = {"autorange": "reversed",
                           "scaleanchor": "x", "scaleratio": 1}
    if title:
        add_title(fig, title)
    return fig


# ===========================================================================
# reference plotly_utils helpers (same names)
# ===========================================================================
def add_title(fig: Figure, title: str) -> None:
    """Centered figure title (reference ``plotly_utils.py:6``)."""
    fig.layout.setdefault("title", {}).update({"text": title, "x": 0.5})


def set_axis_range(fig: Figure, x: Sequence[float], y: Sequence[float]) -> None:
    """Pin both axis ranges (reference ``plotly_utils.py:11``)."""
    fig.layout.setdefault("xaxis", {})["range"] = [min(x), max(x)]
    fig.layout.setdefault("yaxis", {})["range"] = [min(y), max(y)]
    # match the reference's workaround: a reversed image y-axis keeps its
    # direction by reversing the explicit range
    yax = fig.layout["yaxis"]
    if yax.get("autorange") == "reversed":
        yax.pop("autorange")
        yax["range"] = [max(y), min(y)]


def add_vertical_line(fig: Figure, x: float, color: str = "black",
                      width: int = 1, opacity: float = 1,
                      name: str | None = None) -> None:
    """(reference ``plotly_utils.py:18``)"""
    fig.layout.setdefault("shapes", []).append({
        "type": "line", "x0": x, "x1": x, "y0": 0, "y1": 1,
        "yref": "paper", "opacity": opacity,
        "line": {"color": color, "width": width},
        **({"name": name} if name else {})})


def add_horizontal_line(fig: Figure, y: float, color: str = "black",
                        width: int = 1, opacity: float = 1,
                        name: str | None = None) -> None:
    """(reference ``plotly_utils.py:63``)"""
    fig.layout.setdefault("shapes", []).append({
        "type": "line", "y0": y, "y1": y, "x0": 0, "x1": 1,
        "xref": "paper", "opacity": opacity,
        "line": {"color": color, "width": width},
        **({"name": name} if name else {})})
