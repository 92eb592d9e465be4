"""Typed results without pydantic, and enum coercion.

Port of ``ResultBase`` (``pylinac_tpu/core/utilities.py:43``), a pydantic
model there, as a dataclass with the same fields, and of ``convert_to_enum``
(``pylinac_tpu/core/profile.py:127``, the form ``picketfence.py`` imports).
``model_dump()`` and ``model_dump_json()`` keep callers written for the
pydantic models working.
"""

from __future__ import annotations

import dataclasses
import json
from datetime import datetime

from ..version import __version__


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
    raise TypeError(f"Object of type {type(obj).__name__} is not JSON serializable")


@dataclasses.dataclass(kw_only=True)
class ResultBase:
    """Fields every result carries, in the pydantic model's order."""

    pylinac_version: str = __version__
    date_of_analysis: datetime = dataclasses.field(default_factory=datetime.today)
    warnings: list[dict] = dataclasses.field(default_factory=list)

    def model_dump(self) -> dict:
        """The fields as a dict, in declaration order (base fields first)."""
        return dataclasses.asdict(self)

    def model_dump_json(self) -> str:
        """The fields as a JSON object; datetimes in ISO 8601."""
        return json.dumps(self.model_dump(), default=_json_default)
