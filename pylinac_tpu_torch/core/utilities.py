"""Typed results without pydantic, enum coercion, and the device argument.

Port of ``ResultBase`` (``pylinac_tpu/core/utilities.py:43``), a pydantic
model there, as a dataclass with the same fields, of ``ResultsDataMixin``
(``:59-78``), of ``OptionListMixin`` ``:34``, ``is_iterable`` ``:80``,
``simple_round`` ``:84``, ``uniquify`` ``:91``, ``TemporaryAttribute``
``:101``, ``Structure`` ``:117``, ``decode_binary`` ``:127`` (the log
analyzer's binary reader), ``is_close`` ``:245`` and ``is_close_degrees``
``:255``, of the QuAAC
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
from datetime import date, datetime
from typing import BinaryIO, Generic, TypeVar

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
    if isinstance(obj, date):  # ``datetime`` may be patched to freeze the clock
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

    def model_dump(self, *, by_alias: bool = False,
                   exclude: set[str] | None = None) -> dict:
        """The fields as a dict, in declaration order (base fields first),
        without the top-level fields named in ``exclude``. ``by_alias`` is
        accepted as pydantic's is and changes nothing: no result field has
        an alias, in the JAX package either."""
        data = dataclasses.asdict(self)
        for name in exclude or ():
            data.pop(name, None)
        return data

    def model_dump_json(self, *, by_alias: bool = False,
                        exclude: set[str] | None = None) -> str:
        """The fields as a JSON object; datetimes in ISO 8601, numpy scalars
        as Python numbers, infinite and NaN floats as null (as pydantic)."""
        return json.dumps(_finite_or_none(self.model_dump(exclude=exclude)),
                          default=_json_default)

    def output(self, as_dict: bool = False, as_json: bool = False,
               by_alias: bool = False, exclude: set[str] | None = None):
        """What ``results_data(as_dict, as_json, by_alias, exclude)``
        returns: the model, the JSON-compatible dict the JAX package
        returns, or JSON, the last two without the fields in ``exclude``."""
        if as_dict and as_json:
            raise ValueError("Cannot return as both dict and JSON. Pick one.")
        if as_dict:
            return json.loads(self.model_dump_json(exclude=exclude))
        if as_json:
            return self.model_dump_json(exclude=exclude)
        return self


@dataclasses.dataclass(kw_only=True)
class ResultBase(DataModel):
    """Fields every result carries, in the pydantic model's order."""

    pylinac_version: str = __version__
    date_of_analysis: datetime = dataclasses.field(default_factory=datetime.today)
    warnings: list[dict] = dataclasses.field(default_factory=list)


class OptionListMixin:
    """A mixin that lists class attribute options."""

    @classmethod
    def options(cls) -> list[str]:
        return [option for attr, option in cls.__dict__.items()
                if not callable(option) and not attr.startswith("__")]


T = TypeVar("T")


class ResultsDataMixin(Generic[T], WarningCollectorMixin):
    """``results_data()`` from a class's own ``_generate_results_data()``,
    with the warnings its decorated methods captured. Defined here and not
    in each class's body, so that ``capture_warnings`` never wraps it, as in
    the JAX package."""

    def _generate_results_data(self) -> T:
        raise NotImplementedError

    def results_data(self, as_dict: bool = False, as_json: bool = False,
                     by_alias: bool = False, exclude: set[str] | None = None):
        """The typed result; ``as_dict`` gives the JSON-compatible dict the
        JAX package returns, ``as_json`` JSON, each without the top-level
        fields named in ``exclude``. ``by_alias`` changes nothing: no result
        field has an alias."""
        if as_dict and as_json:
            raise ValueError("Cannot return as both dict and JSON. Pick one.")
        data = self._generate_results_data()
        data.warnings = self.get_captured_warnings()
        return data.output(as_dict, as_json, by_alias, exclude)


def is_iterable(obj) -> bool:
    return isinstance(obj, Iterable)


def simple_round(number, decimals: int | None = 0):
    """Round a number but allow None decimals (no-op)."""
    if decimals is None:
        return number
    return round(number, decimals)


def uniquify(seq: list[str], value: str) -> str:
    """``value``, or the first of ``value1``, ``value2``, ... not in ``seq``."""
    if value not in seq:
        return value
    i = 1
    while f"{value}{i}" in seq:
        i += 1
    return f"{value}{i}"


class TemporaryAttribute:
    """Context manager to temporarily set an attribute."""

    def __init__(self, cls, attribute_name, temporary_value):
        self.cls = cls
        self.attribute_name = attribute_name
        self.temporary_value = temporary_value
        self.original_value = getattr(cls, attribute_name)

    def __enter__(self):
        setattr(self.cls, self.attribute_name, self.temporary_value)

    def __exit__(self, exc_type, exc_value, traceback):
        setattr(self.cls, self.attribute_name, self.original_value)


def is_close(val: float, target, delta: float = 1) -> bool:
    """True if ``val`` is within ``delta`` of the target (or any of a
    sequence of targets)."""
    try:
        targets = iter(target)
    except TypeError:
        targets = iter([target])
    return any(t - delta < val < t + delta for t in targets)


def is_close_degrees(angle1: float, angle2: float, delta: float = 1) -> bool:
    """:func:`is_close` on the circle: angles compared the short way around."""
    from .scale import wrap360

    if delta < 0:
        raise ValueError("Delta must be positive")
    simple_diff = abs(wrap360(angle1) - wrap360(angle2))
    return min(simple_diff, 360 - simple_diff) <= delta


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
