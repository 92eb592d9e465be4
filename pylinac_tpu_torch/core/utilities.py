"""Typed results without pydantic, enum coercion, and the device argument.

Port of ``ResultBase`` (``pylinac_tpu/core/utilities.py:43``), a pydantic
model there, as a dataclass with the same fields, of ``ResultsDataMixin``
(``:59-78``), of ``is_iterable`` ``:80``, ``Structure`` ``:117`` and
``decode_binary`` ``:127`` (the log analyzer's binary reader), of the QuAAC
export (``QuaacDatum``, ``QuaacMixin.to_quaac`` and ``_to_yaml``,
``:162-234``), of ``assign2machine`` ``:266`` (through the port's
``core/dcm.py``) and of
``convert_to_enum`` (``pylinac_tpu/core/profile.py:127``, the form
``picketfence.py`` imports). ``model_dump()`` and
``model_dump_json()`` keep callers written for the pydantic models working.
:func:`resolve_device` has no JAX counterpart: the port's analyses take an
explicit device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
from abc import abstractmethod
from collections.abc import Iterable
from datetime import datetime
from typing import BinaryIO

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


def is_iterable(obj) -> bool:
    return isinstance(obj, Iterable)


class Structure:
    """A simple attribute bag."""

    def __init__(self, **kwargs):
        self.__dict__.update(**kwargs)

    def update(self, **kwargs):
        self.__dict__.update(**kwargs)


def decode_binary(file: BinaryIO, dtype, num_values: int = 1, cursor_shift: int = 0,
                  strip_empty: bool = True):
    """Read ``num_values`` values of ``dtype`` from a binary stream: a
    ``struct`` format string, ``str`` (characters, NULs dropped unless
    ``strip_empty`` is false), ``int`` (int32) or ``float`` (float32, as
    Python floats); one value comes back as a scalar, several as an array
    (a string for ``str``). ``cursor_shift`` skips bytes afterwards."""
    f = file
    if isinstance(dtype, str):
        s = struct.calcsize(dtype) * num_values
        output = struct.unpack(dtype * num_values, f.read(s))
        if len(output) == 1:
            output = output[0]
    elif dtype is str:
        ssize = struct.calcsize("c") * num_values
        output = struct.unpack("c" * num_values, f.read(ssize))
        if strip_empty:
            output = "".join(o.decode() for o in output if o != b"\x00")
        else:
            output = "".join(o.decode() for o in output)
    elif dtype is int:
        ssize = struct.calcsize("i") * num_values
        output = np.asarray(struct.unpack("i" * num_values, f.read(ssize)))
        if len(output) == 1:
            output = int(np.squeeze(output))
    elif dtype is float:
        ssize = struct.calcsize("f") * num_values
        output = np.asarray(struct.unpack("f" * num_values, f.read(ssize)))
        if len(output) == 1:
            output = float(np.squeeze(output))
    else:
        raise TypeError(f"datatype '{dtype}' was not valid")
    if cursor_shift:
        f.seek(cursor_shift, 1)
    return output


@dataclasses.dataclass
class QuaacDatum:
    """One data point of a QuAAC QA record."""

    value: str | float | int
    unit: str = ""
    description: str = ""
    reference_value: str | float | int | None = None


class QuaacMixin:
    """Exports an analysis's results as a QuAAC QA document (JSON or YAML),
    written without the ``quaac`` package, as the JAX package writes it."""

    @abstractmethod
    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        raise NotImplementedError

    def to_quaac(self, path, performer: dict | None = None,
                 primary_equipment: dict | None = None, format: str = "json",
                 overwrite: bool = False, **kwargs) -> None:
        """Write the document to ``path``; an existing file raises unless
        ``overwrite``. Each datapoint carries the time of writing."""
        if os.path.exists(str(path)) and not overwrite:
            raise FileExistsError(f"{path} exists; pass overwrite=True to overwrite")
        data = self._quaac_datapoints()
        doc = {
            "version": "1.0",
            "performer": performer or {},
            "primary_equipment": primary_equipment or {},
            "datapoints": [
                {
                    "name": name,
                    "perform_datetime": datetime.now().isoformat(),
                    "measurement_value": d.value,
                    "measurement_unit": d.unit,
                    "description": d.description,
                    "reference_value": d.reference_value,
                }
                for name, d in data.items()
            ],
        }
        with open(path, "w") as f:
            if format == "json":
                json.dump(doc, f, indent=2, default=str)
            else:  # a plain YAML emitter
                f.write(_to_yaml(doc))


def _to_yaml(obj, indent: int = 0) -> str:
    pad = "  " * indent
    lines = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.append(_to_yaml(v, indent + 1))
            else:
                lines.append(f"{pad}{k}: {v if not isinstance(v, (dict, list)) else '{}'}")
    elif isinstance(obj, list):
        for item in obj:
            if isinstance(item, (dict, list)):
                body = _to_yaml(item, indent + 1).lstrip()
                lines.append(f"{pad}- {body}")
            else:
                lines.append(f"{pad}- {item}")
    else:
        lines.append(f"{pad}{obj}")
    return "\n".join(lines)


def assign2machine(source_file: str, machine_file: str) -> None:
    """Copy the TreatmentMachineName of ``machine_file``'s first beam onto
    every beam of ``source_file``, which is overwritten: the way to retarget
    a canned QA plan to a machine."""
    from . import dcm

    dcm_source = dcm.dcmread(source_file)
    dcm_machine = dcm.dcmread(machine_file)
    for beam in dcm_source.BeamSequence:
        beam.TreatmentMachineName = dcm_machine.BeamSequence[0].TreatmentMachineName
    dcm.dcmwrite(source_file, dcm_source)


def not_ported(*names: str):
    """Class decorator: each of ``names`` becomes a method that raises
    ``NotImplementedError``: the reports (plots, PDF, QuAAC) wait for the
    ROADMAP's item 11."""

    def stub(name):
        def method(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} waits for ROADMAP item 11 (reports: plots, PDF, QuAAC) in the port")
        method.__name__ = name
        return method

    def deco(cls):
        for name in names:
            setattr(cls, name, stub(name))
        return cls

    return deco
