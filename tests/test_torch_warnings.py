"""Warnings captured into ``results_data().warnings``, the port against the
JAX package on the CPU.

``capture_warnings`` wraps only the public methods a decorated class's own
body defines; ``results_data`` comes from ``ResultsDataMixin`` and is never
wrapped. The entries are compared on ``(message, category)`` in order: their
``filename`` and ``lineno`` name each package's own source line.
"""

import warnings

import numpy as np
import pytest
import torch

import pylinac_tpu.core.utilities as jutil
import pylinac_tpu.core.warnings as jwarn
import pylinac_tpu.picketfence as jpf
from pylinac_tpu.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
from pylinac_tpu.imggen.simulators import AS500Image
from pylinac_tpu.imggen.utils import generate_picketfence
from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.core import utilities as tutil
from pylinac_tpu_torch.core import warnings as twarn
from pylinac_tpu_torch.imggen.ct import _generate_catphan700
from pylinac_tpu_torch.picketfence import PicketFence

LEAF_WARNING = ("Some leaves were removed from analysis because they were not detected "
                "for all pickets. If valid leaves are missing try adjusting "
                "height_threshold or edge_threshold")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def projection(entries: list[dict]) -> list[tuple[str, str]]:
    return [(e["message"], e["category"]) for e in entries]


def erase_one_kiss(path: str, out: str) -> str:
    """A copy of a vertical-picket fence with the middle picket blanked to
    the background over 12 rows at the frame's centre: about one leaf pair
    is then missing from one picket."""
    img = timage.DicomImage(path)
    a = img.array.copy()
    prof = a.mean(axis=0)
    cols = np.nonzero(prof > (prof.max() + prof.min()) / 2)[0]
    runs = np.split(cols, np.nonzero(np.diff(cols) > 1)[0] + 1)
    mid = runs[len(runs) // 2]
    row = a.shape[0] // 2
    a[row - 6:row + 6, mid[0] - 5:mid[-1] + 6] = np.median(a[:, :runs[0][0] - 10])
    img.array = a
    return img.save(out)


@pytest.fixture(scope="module")
def missing_leaf(tmp_path_factory) -> str:
    tmp = tmp_path_factory.mktemp("pf_warn")
    path = str(tmp / "pf.dcm")
    generate_picketfence(simulator=AS500Image(sid=1500), field_layer=PerfectFieldLayer,
                         file_out=path, final_layers=[GaussianFilterLayer(sigma_mm=1)],
                         picket_width_mm=3, pickets=5, picket_spacing_mm=30)
    return erase_one_kiss(path, str(tmp / "pf_missing.dcm"))


def analysed(make):
    """(the analysed object, the warnings its analyze re-emitted)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        obj = make()
        obj.analyze(tolerance=0.5)
    return obj, caught


def test_picketfence_missing_leaf_warns_as_jax(missing_leaf):
    j, j_caught = analysed(lambda: jpf.PicketFence(missing_leaf))
    t, t_caught = analysed(lambda: PicketFence(missing_leaf, device="cpu"))
    want = projection(j.results_data().warnings)
    got = t.results_data().warnings
    assert want == [(LEAF_WARNING, "UserWarning")]
    assert projection(got) == want
    assert got[0]["filename"].endswith("pylinac_tpu_torch/picketfence.py")
    assert isinstance(got[0]["lineno"], int)
    # both re-emit what they captured
    for caught in (j_caught, t_caught):
        assert [(str(w.message), w.category.__name__) for w in caught
                if str(w.message) == LEAF_WARNING] == want
    # as_dict and as_json carry the same list
    assert projection(t.results_data(as_dict=True)["warnings"]) == want
    assert t.results_data().number_of_pickets == j.results_data().number_of_pickets == 5


def test_picketfence_without_warnings_captures_nothing(tmp_path):
    path = str(tmp_path / "pf.dcm")
    generate_picketfence(simulator=AS500Image(sid=1500), field_layer=PerfectFieldLayer,
                         file_out=path, final_layers=[GaussianFilterLayer(sigma_mm=1)],
                         picket_width_mm=3, pickets=5, picket_spacing_mm=30)
    j, _ = analysed(lambda: jpf.PicketFence(path))
    t, _ = analysed(lambda: PicketFence(path, device="cpu"))
    assert j.results_data().warnings == t.results_data().warnings == []


def test_catphan_that_warns_captures_nothing(tmp_path, monkeypatch):
    """``analyze`` is ``CatPhanBase``'s, so no CatPhan model wraps it; the
    scan (CatPhan 700 at 1 mm pixels) warns in both packages."""
    monkeypatch.setenv("PYLINAC_TPU_CCL", "xla")
    from pylinac_tpu.ct import CatPhan700 as JaxCatPhan700
    from pylinac_tpu_torch.ct import CatPhan700

    _generate_catphan700(tmp_path, num_slices=40, slice_thickness_mm=5, mm_per_pixel=1.0,
                         image_size=256)
    for make in (lambda: JaxCatPhan700(str(tmp_path)), lambda: CatPhan700(str(tmp_path))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ct = make()
            kwargs = {} if isinstance(ct, JaxCatPhan700) else {"device": "cpu"}
            ct.analyze(**kwargs)
            data = ct.results_data()
        assert any(w.category is UserWarning for w in caught)
        assert data.warnings == []
        assert ct.get_captured_warnings() == []


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_decorator_wraps_only_the_class_body(pkg):
    """A decorated class whose public method is inherited from an
    undecorated base captures nothing; one that defines it captures."""
    util, warn = (jutil, jwarn) if pkg == "jax" else (tutil, twarn)

    class Base(util.ResultsDataMixin):
        def run(self):
            warnings.warn("from the base", UserWarning)

    @warn.capture_warnings
    class Inherits(Base):
        pass

    @warn.capture_warnings
    class Defines(Base):
        def run(self):
            warnings.warn("from the body", RuntimeWarning)

        def _private(self):
            warnings.warn("private", UserWarning)

    for cls, want in ((Inherits, []), (Defines, [("from the body", "RuntimeWarning")])):
        obj = cls()
        with pytest.warns((UserWarning, RuntimeWarning)):
            obj.run()
            obj.run()  # duplicates are dropped
        assert projection(obj.get_captured_warnings()) == want
    with pytest.warns(UserWarning, match="private"):
        obj._private()
    assert projection(obj.get_captured_warnings()) == want
    assert "results_data" not in vars(Defines)
    assert not getattr(Defines.results_data, "__wrapped_for_warnings__", False)
