"""Freeze the JAX package's Doselab MC2 kV and MV analyses with their own
detection, for ``tests/test_torch_planar_mc2.py``.

Each class is drawn by ``tests/models/test_planar_longtail.py``'s
``_build_phantom_image`` for its ``SPECS`` entry (an AS1000 frame; the
drawing has no randomness but its seeded noise) and analysed by the JAX
package with no override and nothing patched. ``phantom_angle`` runs the
1001-angle Hough search of ``_phantom_angle_calc`` 14 times an analysis,
about two minutes a class on a CPU: too slow for the Tier-1 run, so the
results are frozen here once and the port is held to them.

Output: ``tests/data/mc2_auto_goldens.json``. For each class, the sha256 of
the drawn pixel array, and either JAX's exception (type and message) or
``results_data()`` without date and version, ``results()`` (its file path
written as ``<path>``), the warnings as (message, category),
``phantom_center`` (x, y), ``phantom_angle`` and ``phantom_radius``. The
file is written byte for byte the same on every run. Regenerate with::

    JAX_PLATFORMS=cpu python scripts/freeze_mc2_goldens.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

CLASSES = ("DoselabMC2kV", "DoselabMC2MV")
OUT = REPO / "tests" / "data" / "mc2_auto_goldens.json"


def pixel_sha256(array) -> str:
    """The hash of a drawn frame: its dtype, shape and C-order bytes."""
    import numpy as np

    array = np.ascontiguousarray(array)
    head = f"{array.dtype.str}{array.shape}".encode()
    return hashlib.sha256(head + array.tobytes()).hexdigest()


def draw(lt, name: str, path: str) -> str:
    """Draw ``name``'s long-tail frame at ``path``; the pixels' hash."""
    from pylinac_tpu.core import dcm

    spec = next(s for s in lt.SPECS if s.cls.__name__ == name)
    lt._build_phantom_image(spec, path)
    return pixel_sha256(dcm.dcmread(path).pixel_array)


def analyse(cls, path: str) -> dict:
    """One analysis with the class's own detection, as a user runs it."""
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            phan = cls(path)
            phan.analyze()
            data = phan.results_data(as_dict=True)
            text = phan.results().replace(phan.image.truncated_path, "<path>")
            center = phan.phantom_center
            out = {"phantom_center": [center.x, center.y],
                   "phantom_angle": phan.phantom_angle,
                   "phantom_radius": phan.phantom_radius}
    except Exception as e:  # noqa: BLE001 - the golden value is JAX's error
        return {"raises": {"type": type(e).__name__, "message": str(e)}}
    data.pop("date_of_analysis")
    data.pop("pylinac_version")
    data["warnings"] = [[w["message"], w["category"]] for w in data["warnings"]]
    return {"results_data": data, "results": text,
            "warnings": [[str(w.message), w.category.__name__] for w in caught], **out}


def freeze() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import pylinac_tpu.planar_imaging as jp
    import tests.models.test_planar_longtail as lt

    golden = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in CLASSES:
            path = str(Path(tmp) / f"{name}.dcm")
            golden[name] = {"pixels_sha256": draw(lt, name, path),
                            **analyse(getattr(jp, name), path)}
    return golden


def main() -> None:
    golden = freeze()
    OUT.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
