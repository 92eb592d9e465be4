"""Decorators: an instance-aware ``lru_cache`` and an argument validator.

Carried over from ``pylinac_tpu/core/decorators.py`` (``lru_cache`` ``:10``,
``validate`` ``:30``), unchanged.
"""

from __future__ import annotations

import functools
import inspect
import weakref


def lru_cache(maxsize: int = 128, typed: bool = False):
    """An lru_cache that holds a weak reference to the instance, so that the
    cache keeps no instance alive."""

    def decorator(func):
        @functools.lru_cache(maxsize=maxsize, typed=typed)
        def _cached(self_ref, *args, **kwargs):
            self = self_ref()
            return func(self, *args, **kwargs)

        @functools.wraps(func)
        def wrapper(self, *args, **kwargs):
            return _cached(weakref.ref(self), *args, **kwargs)

        wrapper.cache_clear = _cached.cache_clear
        return wrapper

    return decorator


def validate(**validators):
    """Validate named arguments with one validator callable or a tuple of
    them."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            bound = inspect.signature(func).bind(*args, **kwargs)
            bound.apply_defaults()
            for name, validator_fns in validators.items():
                if name in bound.arguments:
                    fns = validator_fns if isinstance(validator_fns, (tuple, list)) else (validator_fns,)
                    for fn in fns:
                        fn(bound.arguments[name])
            return func(*args, **kwargs)

        return wrapper

    return decorator
