"""Every public name of the JAX package has its counterpart in the port.

Each module of ``pylinac_tpu`` (private ones, whose path has a part that
starts with ``_``, aside) is read as source: its public module-level
definitions (functions, classes, assignments, also under a top-level ``if``
or ``try``; in a package's ``__init__.py`` also the names it imports from
its own package) and each public class's own members (methods, properties,
class attributes and annotated fields). The same module of
``pylinac_tpu_torch`` must be importable and carry each of them at the same
path: a name by ``getattr``, a member by ``hasattr`` or as an annotated or
dataclass field anywhere in its class's MRO. The names that
``pylinac_tpu/__init__.py`` loads lazily must resolve on
``pylinac_tpu_torch`` as well.

The exceptions are ``LEFT_OUT`` below, the same list as ROADMAP section 1's
"Leave out" and "Also left out": each entry must still name something that
JAX has and the port lacks, so that the list cannot go stale.
"""

from __future__ import annotations

import ast
import importlib
from fnmatch import fnmatchcase
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "pylinac_tpu"

# Paths relative to the package root, as fnmatch patterns.
LEFT_OUT = {
    # ROADMAP §1 "Leave out": the TPU-link workarounds a local card does not need.
    "ops.route": "TPU-link routing",
    "ops.staging": "TPU-link staging",
    "ops.pack": "TPU-link packing",
    "ops.picket_pipeline.picket_fence_batch_packed": "a *_packed wrapper",
    "ops.field_pipeline.field_analysis_batch_packed": "a *_packed wrapper",
    "ops.field_pipeline.field_analysis_strips_batch_packed": "a *_packed wrapper",
    "ops.field_pipeline.field_analysis_wire_packed": "a *_wire_* wrapper",
    "ops.field_pipeline.N_FA_PARAMS": "the *_wire_* wrapper's parameter count",
    "ops.star_pipeline.starshot_batch_packed": "a *_packed wrapper",
    "ops.label.pack_regions": "Regions.to_numpy() replaces it",
    "ops.label.regions_to_host": "Regions.to_numpy() replaces it",
    "ops.label_native": "the host union-find route of ct.py",
    # ROADMAP §1 "Leave out": the Pallas modules; their kernels are
    # csrc/*.cu behind ops/{median,ccl,flood,gamma2d}.py (ROADMAP §2).
    "ops.pallas_median": "csrc/median3x3.cu, ops/median.py",
    "ops.pallas_label": "csrc/ccl.cu and csrc/flood.cu, ops/ccl.py and ops/flood.py",
    "ops.pallas_gamma": "csrc/gamma2d.cu, ops/gamma2d.py",
    # ROADMAP §1 "Leave out": the demo and URL loaders fetch from outside the
    # repository (and clear_data_files deletes their cache).
    "*.from_demo_image": "a demo loader",
    "*.from_demo_images": "a demo loader",
    "*.run_demo": "a demo loader",
    "*.from_url": "a URL loader",
    "core.image.load_url": "a URL loader",
    "core.io.get_url": "a URL loader",
    "core.io.is_url": "a URL loader's test",
    "core.io.retrieve_demo_file": "a demo loader",
    "core.io.DEMO_URL_BASE": "the demo loaders' address",
    "core.utilities.clear_data_files": "deletes the demo loaders' cache",
    "clear_data_files": "deletes the demo loaders' cache",
    # ROADMAP §1 "Leave out": pydantic's model settings; the port's results
    # are dataclasses with model_dump() and model_dump_json().
    "*.model_config": "pydantic's model settings",
    # ROADMAP §1 "Also left out": device helpers that nothing in the JAX
    # package calls outside ops/ and its tests.
    "ops.filters.filter_image": "no caller outside ops/",
    "ops.filters.uniform_filter": "no caller outside ops/",
    "ops.optimize.gaussian_fit_1d": "no caller outside ops/",
    "ops.peaks.fwxm_edges": "no caller outside ops/",
    "ops.peaks.fwhm_center": "no caller outside ops/",
    "ops.interp.interp_linear": "no caller outside ops/",
    "ops.threshold.percentile": "no caller outside ops/",
    "ops.stats.esf_to_mtf": "no caller outside ops/",
    "ops.stats.noise_power_spectrum_1d": "no caller outside ops/",
    "ops.stats.relative_resolution": "no caller outside ops/",
    "ops.stats.michelson_mtf": "no caller outside ops/",
    "ops.star_pipeline.StarParams.min_peak_height": "read only by the folded starshot_image",
    "ops.star_pipeline.StarParams.radius": "read only by the folded starshot_image",
    # ROADMAP §1 "Also left out": what the port computes under another name.
    "ops.label.label": "ops/ccl.py's label",
    "ops.stats.michelson": "core/contrast.py's",
    "ops.stats.weber": "core/contrast.py's",
    "ops.stats.ratio": "core/contrast.py's",
    "ops.stats.difference": "core/contrast.py's",
    "ops.stats.rms": "core/contrast.py's",
    "ops.stats.visibility": "core/contrast.py's",
    "ops.field_pipeline.field_analysis_image": "folded into the batch pipeline",
    "ops.star_pipeline.starshot_image": "folded into the batch pipeline",
}


def _modules(root: Path, package: str) -> list[str]:
    """The public modules under ``root``, as dotted paths below ``package``."""
    out = []
    for py in sorted(root.rglob("*.py")):
        parts = list(py.relative_to(root).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if not any(p.startswith("_") for p in parts):
            out.append(".".join([package, *parts]))
    return out


JAX_MODULES = _modules(JAX_ROOT, "pylinac_tpu")


def _definitions(source: str, package: bool) -> dict[str, ast.ClassDef | None]:
    """Public top-level names defined in ``source`` (and, in a ``package``'s
    ``__init__.py``, imported from within the package); a class maps to its
    node."""
    out: dict[str, ast.ClassDef | None] = {}

    def walk(body):
        for node in body:
            if package and isinstance(node, ast.ImportFrom) and node.level:
                out.update((a.asname or a.name, None) for a in node.names)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[node.name] = None
            elif isinstance(node, ast.ClassDef):
                out[node.name] = node
            elif isinstance(node, ast.Assign):
                out.update((t.id, None) for t in node.targets if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                out[node.target.id] = None
            elif isinstance(node, (ast.If, ast.Try)):
                walk(node.body)
                walk(node.orelse)
                for handler in getattr(node, "handlers", ()):
                    walk(handler.body)

    walk(ast.parse(source).body)
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _members(node: ast.ClassDef) -> list[str]:
    """A class body's own public methods, attributes and annotated fields."""
    out = []
    for n in node.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(n.name)
        elif isinstance(n, ast.Assign):
            out += [t.id for t in n.targets if isinstance(t, ast.Name)]
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.append(n.target.id)
    return [m for m in out if not m.startswith("_")]


def _has_member(cls, name: str) -> bool:
    if hasattr(cls, name) or name in getattr(cls, "__dataclass_fields__", {}):
        return True
    return any(name in getattr(k, "__annotations__", {}) for k in getattr(cls, "__mro__", ()))


def _port_path(jax_path: str) -> str:
    return "pylinac_tpu_torch" + jax_path[len("pylinac_tpu"):]


def _left_out(jax_path: str) -> bool:
    rel = jax_path.partition(".")[2]
    return any(fnmatchcase(rel, pattern) for pattern in LEFT_OUT)


def _missing(jax_module: str) -> list[str]:
    """The public paths of ``jax_module`` that the port lacks, left-outs too."""
    importlib.import_module(jax_module)
    source = JAX_ROOT.joinpath(*jax_module.split(".")[1:])
    package = source.is_dir()
    source = source / "__init__.py" if package else source.with_suffix(".py")
    try:
        port = importlib.import_module(_port_path(jax_module))
    except ModuleNotFoundError:
        return [jax_module]
    missing = []
    for name, node in _definitions(source.read_text(), package).items():
        path = f"{jax_module}.{name}"
        if not hasattr(port, name):
            missing.append(path)
        elif node is not None:
            missing += [f"{path}.{m}" for m in _members(node)
                        if not _has_member(getattr(port, name), m)]
    return missing


def _lazy_missing() -> list[str]:
    """The names ``pylinac_tpu/__init__.py`` loads on first access that the
    port's top level lacks."""
    import pylinac_tpu
    import pylinac_tpu_torch

    return [f"pylinac_tpu.{n}" for n in pylinac_tpu._LAZY_IMPORTS
            if not hasattr(pylinac_tpu_torch, n)]


@pytest.mark.parametrize("jax_module", JAX_MODULES)
def test_module_names_are_ported(jax_module):
    missing = [p for p in _missing(jax_module) if not _left_out(p)]
    assert not missing, "missing in the port (JAX paths): " + ", ".join(missing)


def test_lazy_top_level_names_are_ported():
    missing = [p for p in _lazy_missing() if not _left_out(p)]
    assert not missing, "missing in the port's top level: " + ", ".join(missing)
    import pylinac_tpu_torch

    assert all(hasattr(pylinac_tpu_torch, n) for n in pylinac_tpu_torch.__all__)
    for name in ("PlanarUniformity", "TomographicContrast", "Nuclide", "Device"):
        assert name in pylinac_tpu_torch.__all__, name


def test_every_port_module_imports():
    for module in _modules(REPO / "pylinac_tpu_torch", "pylinac_tpu_torch"):
        importlib.import_module(module)


def test_every_left_out_entry_is_still_left_out():
    """Each entry matches a JAX path that the port lacks: an entry for
    something since ported must go, from here and from the ROADMAP."""
    lacking = [p for m in JAX_MODULES for p in _missing(m)] + _lazy_missing()
    unused = [pattern for pattern in LEFT_OUT
              if not any(fnmatchcase(p.partition(".")[2], pattern) for p in lacking)]
    assert not unused, "left out but ported, or not in JAX: " + ", ".join(unused)
