"""Warnings raised during an analysis, captured into ``results_data().warnings``.

Port of ``pylinac_tpu/core/warnings.py`` (``WarningCollectorMixin`` ``:11``,
``capture_warnings_method_wrapper`` ``:38``, ``capture_warnings`` ``:56``),
unchanged. The class decorator wraps only the public plain functions that
the decorated class's own body defines: an inherited ``analyze`` (every
CatPhan's, from ``CatPhanBase``) captures nothing, as in the JAX package.
The entries' ``filename`` and ``lineno`` name the port's own source lines.
"""

from __future__ import annotations

import functools
import threading
import types
import warnings as warning_module


class WarningCollectorMixin:
    """Thread-safe capture of warnings raised during analysis, without
    duplicates."""

    _warning_lock = threading.Lock()

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._captured_warnings: list[dict] = []

    def get_captured_warnings(self) -> list[dict]:
        return getattr(self, "_captured_warnings", [])

    def _record_warnings(self, caught) -> None:
        if not hasattr(self, "_captured_warnings"):
            self._captured_warnings = []
        with self._warning_lock:
            for w in caught:
                entry = {
                    "message": str(w.message),
                    "category": w.category.__name__,
                    "filename": w.filename,
                    "lineno": w.lineno,
                }
                if entry not in self._captured_warnings:
                    self._captured_warnings.append(entry)


def capture_warnings_method_wrapper(func):
    """Wrap a method so that the warnings raised inside it are recorded on
    the instance, then raised again."""

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        with warning_module.catch_warnings(record=True) as caught:
            warning_module.simplefilter("always")
            result = func(self, *args, **kwargs)
        if isinstance(self, WarningCollectorMixin) or hasattr(self, "_record_warnings"):
            WarningCollectorMixin._record_warnings(self, caught)
        for w in caught:
            warning_module.warn_explicit(w.message, w.category, w.filename, w.lineno)
        return result

    wrapper.__wrapped_for_warnings__ = True
    return wrapper


def capture_warnings(cls):
    """Class decorator: wrap the public plain functions of the class's own
    body. Classes and other callables stored as class attributes (such as
    ``image_type = SomeClass``) pass through untouched."""
    for name, attr in list(vars(cls).items()):
        if (isinstance(attr, types.FunctionType) and not name.startswith("_")
                and not getattr(attr, "__wrapped_for_warnings__", False)):
            setattr(cls, name, capture_warnings_method_wrapper(attr))
    return cls
