"""The public names the port took last, against the JAX package on the CPU.

The image stacks (``array_3d`` and ``side_view`` of the eager and the lazy
stack, ``roll``) on a 3-slice CT series; ``DicomImage.from_dataset`` and
``BaseImage.from_multiples`` (arrays and metadata); the ROIs' full-frame
``masked_array`` on a 64 x 64 image, NaN in the same places;
``create_dicom_files_from_3d_array``'s files read back; the ``is_monotonic``
trio, ``simple_round``, ``uniquify``, ``TemporaryAttribute``, ``is_close``,
``is_close_degrees``, ``Contrast.options()``, the degree ``tan`` and
``atan``, ``vector_is_close``, ``to_json``, ``MachineScaleEnumStr`` and the
``TomgraphicSphere`` type; ``Simulator.plot`` and ``MetricBase.plotly`` and
``additional_plots`` (figures by signature, as the report tests compare
them). Arrays and values equal to JAX's, floats to the bit; the files'
pixels and tags equal but for the UIDs, which each writer draws anew.
"""

import dataclasses
import typing
from functools import cached_property

import numpy as np
import pytest

from pylinac_tpu_torch.core import array_utils as tarr
from pylinac_tpu_torch.core import contrast as tcontrast
from pylinac_tpu_torch.core import dcm as tdcm
from pylinac_tpu_torch.core import geometry as tgeo
from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.core import roi as troi
from pylinac_tpu_torch.core import scale as tscale
from pylinac_tpu_torch.core import utilities as tutil
from pylinac_tpu_torch.imggen import simulators as tsim
from pylinac_tpu_torch.metrics import image as tmetrics

from tests.test_torch_reports import _assert_same_figure, plt

# the fixture above is imported to be used here
__all__ = ["plt"]


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    from types import SimpleNamespace

    import pylinac_tpu.core.array_utils as arr
    import pylinac_tpu.core.contrast as contrast
    import pylinac_tpu.core.dcm as dcm
    import pylinac_tpu.core.geometry as geo
    import pylinac_tpu.core.image as image
    import pylinac_tpu.core.roi as roi
    import pylinac_tpu.core.scale as scale
    import pylinac_tpu.core.utilities as util
    import pylinac_tpu.imggen.simulators as sim
    import pylinac_tpu.metrics.image as metrics
    import pylinac_tpu.nuclear as nuclear

    return SimpleNamespace(arr=arr, contrast=contrast, dcm=dcm, geo=geo, image=image, roi=roi,
                           scale=scale, util=util, sim=sim, metrics=metrics, nuclear=nuclear)


def _volume() -> np.ndarray:
    return np.random.default_rng(21).integers(0, 4000, (3, 40, 48)).astype(np.uint16)


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    """A 3-slice CT series of 40 x 48 slices, 2.5 mm apart, written in
    reverse z order."""
    folder = tmp_path_factory.mktemp("series")
    uid = tdcm.generate_uid()
    for i, plane in enumerate(_volume()):
        ds = tarr.array_to_dicom(plane, sid=1000, gantry=0, coll=0, couch=0, dpi=25.4, extra_tags={
            "Modality": "CT", "SeriesInstanceUID": uid, "RescaleSlope": 1.0,
            "RescaleIntercept": -1024.0, "ImagePositionPatient": [0.0, 0.0, 2.5 * (2 - i)]})
        tdcm.dcmwrite(folder / f"{i}.dcm", ds)
    return str(folder)


def _stacks(image, series):
    return {"eager": image.DicomImageStack(series, min_number=3),
            "lazy": image.LazyDicomImageStack(series, min_number=3)}


@pytest.mark.parametrize("kind", ["eager", "lazy"])
def test_stack_volume_and_side_views_match_jax(jax, series, kind, monkeypatch):
    got, want = _stacks(timage, series)[kind], _stacks(jax.image, series)[kind]
    if kind == "lazy":  # the volume is filled a slice at a time, not from every image
        monkeypatch.setattr(timage.LazyDicomImageStack, "images",
                            property(lambda self: pytest.fail("array_3d read .images")))
    volume = got.array_3d()
    assert volume.dtype == np.float32 and volume.shape == (3, 40, 48)
    np.testing.assert_array_equal(volume, want.array_3d())
    # z-sorted: the last slice written is the first
    np.testing.assert_array_equal(volume, _volume()[::-1].astype(np.float32) - 1024)
    monkeypatch.undo()
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(got.side_view(axis), want.side_view(axis))


@pytest.mark.parametrize("direction,amount", [("x", 3), ("y", -2)])
def test_stack_roll_matches_jax(jax, series, direction, amount):
    got, want = _stacks(timage, series)["eager"], _stacks(jax.image, series)["eager"]
    got.roll(direction, amount)
    want.roll(direction, amount)
    np.testing.assert_array_equal(got.array_3d(), want.array_3d())
    np.testing.assert_array_equal(
        got.array_3d(), np.roll(_volume()[::-1], amount, axis=2 if direction == "x" else 1) - 1024.0)


def test_from_dataset_matches_jax(jax, series):
    path = f"{series}/1.dcm"
    got = timage.DicomImage.from_dataset(tdcm.dcmread(path))
    want = jax.image.DicomImage.from_dataset(jax.dcm.dcmread(path))
    np.testing.assert_array_equal(got.array, want.array)
    assert got.array.dtype == want.array.dtype
    assert got.source == want.source == "stream"
    for tag in ("Modality", "SeriesInstanceUID", "SOPInstanceUID", "ImagePositionPatient",
                "RescaleIntercept", "ImagePlanePixelSpacing"):
        assert got.metadata.get(tag) == want.metadata.get(tag), tag
    assert (got.dpmm, got.z_position) == (want.dpmm, want.z_position)


@pytest.mark.parametrize("method", ["mean", "max", "sum"])
def test_from_multiples_matches_jax(jax, series, method):
    paths = [f"{series}/{i}.dcm" for i in range(3)]
    got = timage.DicomImage.from_multiples(paths, method=method)
    want = jax.image.DicomImage.from_multiples(paths, method=method)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.array, want.array)
    assert got._raw_pixels is want._raw_pixels is True
    assert got.metadata.get("SOPInstanceUID") == want.metadata.get("SOPInstanceUID")
    assert got.dpmm == want.dpmm


@pytest.mark.parametrize("case", ["disk", "rect", "rect_rotated"])
def test_masked_arrays_match_jax(jax, case):
    image = np.random.default_rng(5).normal(100, 10, (64, 64)).astype(np.float32)
    make = {"disk": lambda roi, geo: roi.DiskROI(image, radius=9.3, center=geo.Point(30.4, 25.7)),
            "rect": lambda roi, geo: roi.RectangleROI(image, 20, 12, geo.Point(33.5, 29.0)),
            "rect_rotated": lambda roi, geo: roi.RectangleROI(image, 20, 12, geo.Point(33.5, 29.0),
                                                              rotation=30.0)}[case]
    got, want = make(troi, tgeo), make(jax.roi, jax.geo)
    if case == "disk":
        got_arr, want_arr = got.masked_array(), want.masked_array()
    else:
        assert isinstance(vars(troi.RectangleROI)["masked_array"], cached_property)
        got_arr, want_arr = got.masked_array, want.masked_array
    assert got_arr.dtype == np.float64 and got_arr.shape == (64, 64)
    np.testing.assert_array_equal(np.isnan(got_arr), np.isnan(want_arr))
    np.testing.assert_array_equal(got_arr, want_arr)
    assert 0 < np.isfinite(got_arr).sum() < 64 * 64


def test_dicom_files_from_3d_array_read_back_equal(jax, tmp_path):
    volume = np.random.default_rng(9).integers(0, 3000, (24, 32, 3)).astype(np.float64)
    got = tarr.create_dicom_files_from_3d_array(volume, tmp_path / "port", slice_thickness=2.5,
                                                pixel_size=0.8)
    want = jax.arr.create_dicom_files_from_3d_array(volume, tmp_path / "jax", slice_thickness=2.5,
                                                    pixel_size=0.8)
    assert sorted(p.name for p in got.iterdir()) == sorted(p.name for p in want.iterdir()) \
        == ["0.dcm", "1.dcm", "2.dcm"]
    skip = {tdcm.DICT[k][0] for k in ("SOPInstanceUID", "StudyInstanceUID",
                                      "SeriesInstanceUID", "PixelData")}
    for i in range(3):
        for read in (tdcm.dcmread, jax.dcm.dcmread):
            a, b = read(got / f"{i}.dcm"), read(want / f"{i}.dcm")
            np.testing.assert_array_equal(a.pixel_array, b.pixel_array)
            np.testing.assert_array_equal(a.pixel_array, volume[..., i].astype(np.uint16))
            tags = {e.tag: e.value for e in a if e.tag not in skip}
            assert tags == {e.tag: e.value for e in b if e.tag not in skip}
            assert len(tags) > 10 and tags[tdcm.DICT["SliceThickness"][0]] == 2.5
    stack = timage.DicomImageStack(got, min_number=3)
    assert len({img.metadata.get("SeriesInstanceUID") for img in stack.images}) == 1


def test_helpers_match_jax(jax):
    arrays = [np.array([1, 2, 3]), np.array([3, 2, 1]), np.array([1, 1, 2]), np.array([1, 3, 2]),
              np.array([5.0])]
    for name in ("is_monotonically_increasing", "is_monotonically_decreasing", "is_monotonic"):
        assert [getattr(tarr, name)(a) for a in arrays] == \
            [getattr(jax.arr, name)(a) for a in arrays], name
    for args in ((3.14159, 2), (2.5, None), (7.45, 1), (2.5, 0)):
        assert tutil.simple_round(*args) == jax.util.simple_round(*args)
    for seq, value in ((["a", "b"], "c"), (["a", "a1"], "a"), (["x", "x1", "x2"], "x")):
        assert tutil.uniquify(seq, value) == jax.util.uniquify(seq, value)
    for util in (tutil, jax.util):
        holder = type("Holder", (), {"value": 1})
        with util.TemporaryAttribute(holder, "value", 5):
            assert holder.value == 5
        assert holder.value == 1
    for args in ((1.0, 1.5), (1.0, [5, 1.4]), (3.0, 1.0, 2.5), (2.0, (0, 4)), (1.0, 2.0, 1)):
        assert tutil.is_close(*args) == jax.util.is_close(*args), args
    for args in ((359.5, 0.2), (10, 350, 25), (180, -180), (90, 92), (0.5, 359.0, 1.5)):
        assert tutil.is_close_degrees(*args) == jax.util.is_close_degrees(*args), args
    with pytest.raises(ValueError, match="Delta must be positive"):
        tutil.is_close_degrees(0, 1, delta=-1)
    assert tcontrast.Contrast.options() == jax.contrast.Contrast.options() == \
        ["Michelson", "Weber", "Ratio", "Root Mean Square", "Difference"]
    for x in (0.0, 30.0, 45.0, -60.0, 100.0):
        assert tgeo.tan(x) == jax.geo.tan(x)
        assert tgeo.atan(x, 7.0) == jax.geo.atan(x, 7.0)
    pairs = [((1, 2, 3), (1.05, 2, 3), {}), ((1, 2, 3), (1.2, 2, 3), {}),
             ((0, 0, 0), (0.3, -0.3, 0.3), {"delta": 0.3})]
    for a, b, kw in pairs:
        assert tgeo.vector_is_close(tgeo.Vector(*a), tgeo.Vector(*b), **kw) == \
            jax.geo.vector_is_close(jax.geo.Vector(*a), jax.geo.Vector(*b), **kw)
    assert tgeo.to_json(tgeo.Point(1.5, -2, 3)) == jax.geo.to_json(jax.geo.Point(1.5, -2, 3))
    assert tgeo.to_json(tgeo.Vector(1.5, -2, 3)) == jax.geo.to_json(jax.geo.Vector(1.5, -2, 3))
    for scale in (tscale, jax.scale):
        assert issubclass(scale.MachineScaleEnumStr, str)
        assert list(scale.MachineScaleEnumStr) == []
    from pylinac_tpu_torch import nuclear as tnuclear

    assert typing.get_type_hints(tnuclear.TomgraphicSphere) == \
        typing.get_type_hints(jax.nuclear.TomgraphicSphere)
    spheres = {f.name: f.type for f in dataclasses.fields(tnuclear.TomographicContrastResults)}
    assert spheres["spheres"] == "dict[str, TomgraphicSphere]"
    assert str(jax.nuclear.TomographicContrastResults.model_fields["spheres"].annotation) == \
        "dict[str, pylinac_tpu.nuclear.TomgraphicSphere]"


def test_plots_match_jax(jax, plt):
    from pylinac_tpu.imggen.layers import FilteredFieldLayer as JLayer

    from pylinac_tpu_torch.imggen.layers import FilteredFieldLayer as TLayer

    figures = []
    for sim, layer in ((tsim, TLayer), (jax.sim, JLayer)):
        s = sim.AS500Image(sid=1000)
        s.add_layer(layer(field_size_mm=(60, 40)))
        figures.append(s.plot(show=False).figure)
    _assert_same_figure(*figures)

    for metrics in (tmetrics, jax.metrics):
        metric = type("Metric", (metrics.MetricBase,), {"calculate": lambda self: 0})()
        fig = plt.figure()
        assert metric.plotly(fig) is None and metric.additional_plots() == []
        assert fig.axes == []
