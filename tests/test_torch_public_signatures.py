"""Every public function and method that the JAX package and the port both
have takes, in the port, each of JAX's parameters with JAX's default.

The JAX side is read as source, as ``tests/test_torch_public_names.py``
reads it: each public module's public functions, and each public class's
own public methods and ``__init__``, with their parameters (``self`` and
``cls`` aside) and the defaults' expressions, evaluated in the module's
and the class's namespace; a property with a setter must have one in the
port too. The port side is the object at the
same path, found by ``getattr`` along its class's MRO, and its
``inspect.signature``. A name the port lacks is
``test_torch_public_names.py``'s business, not this file's.

Two defaults are the same when they are equal numbers or strings (NaN
and NaN too), members
of the same enumeration by name, functions or classes of the same name,
sequences of the same defaults, or instances of the same class name with
the same attributes (or the same text, where they have none). The exceptions are ``DELIBERATE``
below: each key is a dotted path below the package plus a parameter (an
``fnmatch`` pattern), each value why the port differs. Each entry must
still match a difference that exists, so that the list cannot go stale.
"""

from __future__ import annotations

import ast
import enum
import importlib
import inspect
from fnmatch import fnmatchcase

import numpy as np
import pytest

from tests.test_torch_public_names import JAX_MODULES, JAX_ROOT, _port_path

DELIBERATE = {
    # ops/interp.py's callers in JAX sample with order 1 and no fill value
    # only (grep -rn "map_coordinates(" pylinac_tpu).
    "ops.interp.map_coordinates.order": "linear only; JAX's callers use order 1",
    "ops.interp.map_coordinates.cval": "linear only; JAX's callers pass no cval",
    # The port's ccl.cu labels to the fixpoint, and the Pallas kernels'
    # iteration caps, fill values and chunking have no counterpart
    # (ROADMAP section 3).
    "ops.label.*.max_iter": "ccl.cu labels to the fixpoint",
    "ops.label.*.fill": "the Pallas kernels' padding value",
    "ops.label.*.chunk": "the Pallas kernels' chunking",
    # torch names the axis of a reduction ``dim``.
    "ops.filters.*.axis": "torch's ``dim``",
    # The picket pipeline's TPU knobs: the KISS top-k width, the peak
    # finder's distance fraction and the host/device pre-processing
    # switches (grep -rn "KISS_K\|min_distance_frac\|despike=" pylinac_tpu).
    "ops.picket_pipeline.*.KISS_K": "the TPU's top-k width",
    "ops.picket_pipeline.*.min_distance_frac": "a fixed fraction in the port",
    "ops.picket_pipeline.*.preprocess": "the port always pre-processes on the device",
    "ops.picket_pipeline.*.despike": "the port's de-spike is PicketFence's filter",
    # The hull and per-row thresholds of find_features, and the host
    # switches of the threshold helpers (grep -rn "compute_hull\|
    # batch_thresholds\|host=" pylinac_tpu/metrics).
    "metrics.utils.find_features.compute_hull": "the port always computes the hull",
    "metrics.utils.find_features.batch_thresholds": "the port thresholds per row",
    "metrics.utils.valid_region_views.host": "the port chooses its device",
    "ops.threshold.otsu_threshold.host": "the port chooses its device",
    # CT region helpers: hole filling is the holes mode of ccl.cu, and the
    # port's batch always returns intensities (grep -rn "fill_holes=\|
    # want_intensity=" pylinac_tpu).
    "ct.get_regions.fill_holes": "filled areas come from ccl.cu's holes mode",
    "ct.get_regions_batch.want_intensity": "the port's batch always returns intensities",
    # The sharded gamma takes the gamma's arguments by name.
    "parallel.mesh.sharded_gamma_2d.gamma_kwargs": "the gamma's arguments are named",
    # The port's StarshotBatch and its pipeline chunk by the card's memory
    # unless asked.
    "starshot.StarshotBatch.analyze.chunk": "None: sized to the card's memory",
    "ops.star_pipeline.starshot_batch.chunk": "None: sized to the card's memory",
    # The cubic zoom's helpers: JAX's callers resample 1D profiles with edge
    # mode "nearest" along the last axis only (grep -rn "zoom1d(\|
    # spline_filter1d(\|map_coordinates1d_cubic(" pylinac_tpu).
    "ops.interp.zoom1d.mode": "\"nearest\" only, JAX's callers' mode",
    "ops.interp.spline_filter1d.mode": "\"nearest\" only, JAX's callers' mode",
    "ops.interp.spline_filter1d.axis": "1D profiles only",
    "ops.interp.map_coordinates1d_cubic.mode": "\"nearest\" only, JAX's callers' mode",
}

_SKIP_DECORATORS = {"property", "cached_property", "setter", "deleter", "getter"}


def _decorator_names(node) -> set[str]:
    out = set()
    for d in node.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        out.add(d.attr if isinstance(d, ast.Attribute) else getattr(d, "id", ""))
    return out


def _params(node, method: bool) -> list[tuple[str, ast.expr | None]]:
    """(name, default expression) of a function node's parameters, ``self``
    or ``cls`` aside; ``*args`` and ``**kwargs`` by their names."""
    a = node.args
    positional = a.posonlyargs + a.args
    defaults = [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
    out = list(zip((p.arg for p in positional), defaults))
    if method and "staticmethod" not in _decorator_names(node):
        out = out[1:]
    if a.vararg:
        out.append((a.vararg.arg, None))
    out += list(zip((p.arg for p in a.kwonlyargs), a.kw_defaults))
    if a.kwarg:
        out.append((a.kwarg.arg, None))
    return out


def _functions(source: str):
    """(dotted name, node, class name or None) of the public functions, and
    of each public class's own public methods and ``__init__``; a property
    with a setter as (dotted name, None, class name)."""
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                yield node.name, node, None
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for n in node.body:
                if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if n.name.startswith("_") and n.name != "__init__":
                    continue
                decorators = _decorator_names(n)
                if "setter" in decorators:
                    yield f"{node.name}.{n.name}", None, node.name
                elif not decorators & _SKIP_DECORATORS:
                    yield f"{node.name}.{n.name}", n, node.name


def _port_signature(module, dotted: str):
    """The port's signature at ``dotted``, ``self`` or ``cls`` aside, or None
    where the port lacks the name or has no callable there."""
    obj = module
    parts = dotted.split(".")
    for part in parts[:-1]:
        obj = getattr(obj, part, None)
    if obj is None:
        return None
    if inspect.isclass(obj):
        raw = next((k.__dict__[parts[-1]] for k in obj.__mro__ if parts[-1] in k.__dict__), None)
        if isinstance(raw, staticmethod):
            func, drop = raw.__func__, 0
        elif isinstance(raw, classmethod):
            func, drop = raw.__func__, 1
        elif callable(raw) and not inspect.isclass(raw):
            func, drop = raw, 1
        else:
            return None
    else:
        func, drop = getattr(obj, parts[-1], None), 0
        if func is None or inspect.isclass(func) or not callable(func):
            return None
    try:
        params = list(inspect.signature(func).parameters.values())
    except (TypeError, ValueError):
        return None
    return {p.name: p for p in params[drop:]}


def _same_default(a, b) -> bool:
    if isinstance(a, enum.Enum) or isinstance(b, enum.Enum):
        return (type(a).__name__ == type(b).__name__
                and getattr(a, "name", a) == getattr(b, "name", b))
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_default(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b  # NaN
    if isinstance(a, (int, float, str, type(None))) or isinstance(b, (int, float, str)):
        return a == b
    if inspect.isroutine(a) or inspect.isclass(a):
        return getattr(a, "__name__", a) == getattr(b, "__name__", b)
    # an instance: the same class name and the same attributes, or the same
    # text where it has no attributes of its own
    if type(a).__name__ != type(b).__name__:
        return False
    if not hasattr(a, "__dict__") or not hasattr(b, "__dict__"):
        return repr(a) == repr(b)
    return _same_default(sorted(vars(a).items()), sorted(vars(b).items()))


def _differences(jax_module: str) -> list[str]:
    """``path.parameter: what differs`` for each JAX parameter that the
    port's counterpart lacks or defaults otherwise."""
    jmod = importlib.import_module(jax_module)
    try:
        pmod = importlib.import_module(_port_path(jax_module))
    except ModuleNotFoundError:
        return []
    source = JAX_ROOT.joinpath(*jax_module.split(".")[1:])
    source = source / "__init__.py" if source.is_dir() else source.with_suffix(".py")
    out = []
    for dotted, node, owner in _functions(source.read_text()):
        path = f"{jax_module.partition('.')[2]}.{dotted}".lstrip(".")
        if node is None:  # a property's setter
            cls = getattr(pmod, owner, None)
            prop = inspect.getattr_static(cls, dotted.split(".")[-1], None) if cls else None
            if isinstance(prop, property) and prop.fset is None:
                out.append(f"{path}.setter: missing")
            continue
        port = _port_signature(pmod, dotted)
        if port is None:
            continue
        namespace = dict(vars(jmod))
        if owner is not None:
            namespace.update(getattr(getattr(jmod, owner, None), "__dict__", {}))
        for name, default in _params(node, owner is not None):
            if name not in port:
                out.append(f"{path}.{name}: missing")
                continue
            got = port[name].default
            if default is None:
                if got is not inspect.Parameter.empty:
                    out.append(f"{path}.{name}: the port has a default, JAX none")
                continue
            want = eval(compile(ast.Expression(default), "<default>", "eval"), namespace)
            if got is inspect.Parameter.empty:
                out.append(f"{path}.{name}: no default in the port, JAX {want!r}")
            elif not _same_default(want, got):
                out.append(f"{path}.{name}: default {got!r}, JAX {want!r}")
    return out


def _deliberate(difference: str) -> bool:
    path = difference.partition(":")[0]
    return any(fnmatchcase(path, pattern) for pattern in DELIBERATE)


@pytest.mark.parametrize("jax_module", JAX_MODULES)
def test_module_signatures_are_ported(jax_module):
    found = [d for d in _differences(jax_module) if not _deliberate(d)]
    assert not found, "the port differs from JAX: " + "; ".join(found)


def test_every_deliberate_entry_is_still_a_difference():
    """Each entry matches a difference that exists: an entry whose
    parameter the port has since taken must go."""
    found = [d.partition(":")[0] for m in JAX_MODULES for d in _differences(m)]
    unused = [pattern for pattern in DELIBERATE
              if not any(fnmatchcase(p, pattern) for p in found)]
    assert not unused, "deliberate but not a difference: " + ", ".join(unused)


def test_results_data_takes_jax_arguments():
    """``results_data``'s parameters and defaults, in the port's mixin and in
    JAX's, and the model's dumps take ``by_alias`` and ``exclude``."""
    pytest.importorskip("jax")
    from pylinac_tpu.core.utilities import ResultsDataMixin as JaxMixin
    from pylinac_tpu_torch.core.utilities import DataModel, ResultsDataMixin

    def sig(f):
        return [(p.name, p.default) for p in inspect.signature(f).parameters.values()]

    assert sig(ResultsDataMixin.results_data) == sig(JaxMixin.results_data)
    for dump in (DataModel.model_dump, DataModel.model_dump_json):
        params = inspect.signature(dump).parameters
        assert params["by_alias"].default is False and params["exclude"].default is None
