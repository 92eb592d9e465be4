"""The port's Doselab MC2 kV and MV analysed as a user analyses them, with
their own detection (no override, nothing patched), against the JAX
package's frozen results.

Each class is drawn by ``tests/models/test_planar_longtail.py``'s
``_build_phantom_image`` for its ``SPECS`` entry, as
``scripts/freeze_mc2_goldens.py`` drew it; the drawn pixels' sha256 must
equal the frozen one, so a changed drawing fails here and not as a changed
result. JAX's analysis of each runs its 1001-angle Hough search 14 times
(about two minutes a class on a CPU), so its results are frozen in
``tests/data/mc2_auto_goldens.json``; the port runs on the CPU and is held
to them: ``results_data()`` without date and version at the bar (mm 0.01,
% 0.1, contrast, CNR and rMTF 0.1 %, px and degrees 1e-3; integers and
strings exact), ``results()`` (its file path written as ``<path>``) and the
warnings exact, and the phantom's centre, angle and radius within 1e-3.
Where JAX raised, the port must raise the same type with the same message.
"""

import hashlib
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import pylinac_tpu_torch.planar_imaging as tp
from pylinac_tpu_torch.core import dcm as tdcm

from tests.test_torch_planar import _data, card_agrees

GOLDENS = json.loads((Path(__file__).parent / "data" / "mc2_auto_goldens.json").read_text())
CLASSES = ["DoselabMC2kV", "DoselabMC2MV"]
_DRAWN = {}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lt():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tests.models.test_planar_longtail as lt

    return lt


def _pixel_sha256(array: np.ndarray) -> str:
    """The frozen hash's form: dtype, shape and C-order bytes."""
    array = np.ascontiguousarray(array)
    return hashlib.sha256(f"{array.dtype.str}{array.shape}".encode() + array.tobytes()).hexdigest()


def _drawn(lt, tmp_path_factory, name: str) -> str:
    """``name``'s frame, drawn once a module."""
    if name not in _DRAWN:
        spec = next(s for s in lt.SPECS if s.cls.__name__ == name)
        path = str(tmp_path_factory.mktemp("mc2") / f"{name}.dcm")
        lt._build_phantom_image(spec, path)
        _DRAWN[name] = path
    return _DRAWN[name]


@pytest.mark.parametrize("name", CLASSES)
def test_drawing_is_the_frozen_one(lt, tmp_path_factory, name):
    path = _drawn(lt, tmp_path_factory, name)
    assert _pixel_sha256(tdcm.dcmread(path).pixel_array) == GOLDENS[name]["pixels_sha256"]


@pytest.mark.parametrize("name", CLASSES)
def test_own_detection_matches_frozen_jax(lt, tmp_path_factory, name):
    path = _drawn(lt, tmp_path_factory, name)
    golden = GOLDENS[name]
    if "raises" in golden:
        with pytest.raises(Exception) as caught:
            getattr(tp, name)(path).analyze(device="cpu")
        assert [type(caught.value).__name__, str(caught.value)] == \
            [golden["raises"]["type"], golden["raises"]["message"]]
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        phan = getattr(tp, name)(path)
        phan.analyze(device="cpu")
        data = _data(phan)
        text = phan.results().replace(phan.image.truncated_path, "<path>")
    card_agrees(data, golden["results_data"])
    assert text == golden["results"]
    assert [[str(w.message), w.category.__name__] for w in caught] == golden["warnings"]
    center = phan.phantom_center
    assert [center.x, center.y] == pytest.approx(golden["phantom_center"], abs=1e-3)
    assert phan.phantom_angle == pytest.approx(golden["phantom_angle"], abs=1e-3)
    assert phan.phantom_radius == pytest.approx(golden["phantom_radius"], abs=1e-3)
    assert data["analysis_type"] == phan.common_name
