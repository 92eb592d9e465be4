"""Typed results without pydantic, enum coercion, and the device argument.

Port of ``ResultBase`` (``pylinac_tpu/core/utilities.py:43``), a pydantic
model there, as a dataclass with the same fields, of ``ResultsDataMixin``
(``:59-78``) and of ``convert_to_enum`` (``pylinac_tpu/core/profile.py:127``,
the form ``picketfence.py`` imports). ``model_dump()`` and
``model_dump_json()`` keep callers written for the pydantic models working.
:func:`resolve_device` has no JAX counterpart: the port's analyses take an
explicit device.
"""

from __future__ import annotations

import dataclasses
import json
import math
from datetime import datetime

import numpy as np
import torch

from ..version import __version__
from .warnings import WarningCollectorMixin


def resolve_device(device, caller: str) -> torch.device:
    """``None`` means CUDA; a CUDA device must exist."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller} runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return device


def convert_to_enum(value, enum_cls):
    """An enum member from a member, its value or its name (case-insensitive
    on names and string values)."""
    if isinstance(value, enum_cls):
        return value
    for member in enum_cls:
        if member.value == value or member.name == str(value).upper():
            return member
    for member in enum_cls:
        if str(member.value).lower() == str(value).lower():
            return member
    raise ValueError(f"{value} is not a valid {enum_cls}")


def _json_default(obj):
    if isinstance(obj, datetime):
        return obj.isoformat()
    if isinstance(obj, np.generic):  # numpy scalars, as pydantic coerces them
        return _finite_or_none(obj.item())
    raise TypeError(f"Object of type {type(obj).__name__} is not JSON serializable")


def _finite_or_none(value):
    """``value`` with every infinite or NaN float made None, nested ones
    too: pydantic writes them to JSON as null."""
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, dict):
        return {k: _finite_or_none(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_finite_or_none(v) for v in value]
    return value


_COERCE = {"float": float, "int": int, "bool": bool, "str": str}


class DataModel:
    """``model_dump()`` and ``model_dump_json()`` for a result dataclass, and
    pydantic's coercion of its scalar fields: a field declared ``float``,
    ``int``, ``bool`` or ``str`` (or that or None, or a list of it) holds
    that Python type, so 40 becomes 40.0 and numpy scalars become Python
    numbers, as in the JAX package's models."""

    def __post_init__(self):
        for field in dataclasses.fields(self):
            kind = str(field.type)
            value = getattr(self, field.name)
            if value is None:
                continue
            kind = kind.removesuffix(" | None")
            if kind in _COERCE:
                setattr(self, field.name, _COERCE[kind](value))
            elif kind.startswith("list[") and kind[5:-1] in _COERCE:
                setattr(self, field.name, [_COERCE[kind[5:-1]](v) for v in value])

    def model_dump(self) -> dict:
        """The fields as a dict, in declaration order (base fields first)."""
        return dataclasses.asdict(self)

    def model_dump_json(self) -> str:
        """The fields as a JSON object; datetimes in ISO 8601, numpy scalars
        as Python numbers, infinite and NaN floats as null (as pydantic)."""
        return json.dumps(_finite_or_none(self.model_dump()), default=_json_default)

    def output(self, as_dict: bool = False, as_json: bool = False):
        """What ``results_data(as_dict, as_json)`` returns: the model, the
        JSON-compatible dict the JAX package returns, or JSON."""
        if as_dict and as_json:
            raise ValueError("Cannot return as both dict and JSON. Pick one.")
        if as_dict:
            return json.loads(self.model_dump_json())
        if as_json:
            return self.model_dump_json()
        return self


@dataclasses.dataclass(kw_only=True)
class ResultBase(DataModel):
    """Fields every result carries, in the pydantic model's order."""

    pylinac_version: str = __version__
    date_of_analysis: datetime = dataclasses.field(default_factory=datetime.today)
    warnings: list[dict] = dataclasses.field(default_factory=list)


class ResultsDataMixin(WarningCollectorMixin):
    """``results_data()`` from a class's own ``_generate_results_data()``,
    with the warnings its decorated methods captured. Defined here and not
    in each class's body, so that ``capture_warnings`` never wraps it, as in
    the JAX package."""

    def _generate_results_data(self) -> ResultBase:
        raise NotImplementedError

    def results_data(self, as_dict: bool = False, as_json: bool = False):
        """The typed result; ``as_dict`` gives the JSON-compatible dict the
        JAX package returns, ``as_json`` JSON."""
        if as_dict and as_json:
            raise ValueError("Cannot return as both dict and JSON. Pick one.")
        data = self._generate_results_data()
        data.warnings = self.get_captured_warnings()
        return data.output(as_dict, as_json)
