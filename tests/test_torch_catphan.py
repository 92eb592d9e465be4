"""The port's CatPhan 504 analysis against the JAX package's, on one
synthetic 60-slice scan (2.5 mm slices, 0.5 mm pixels), the size of the
bench's scans.

JAX runs with ``PYLINAC_TPU_CCL=xla``, so that it takes the same device
route as the port (mask stage, batched CCL, region properties) rather than
its host C++ union-find. The port runs on the CPU (its plain twins).

Tolerances (BASELINE.json's parity bar): integers, booleans, strings and
dict keys exact; every other float (mm, HU, MTF, NPS) within 0.01 absolute
or 0.1 % relative, whichever is larger; the roll within 0.01 degree.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import ct as tct
from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.imggen.ct import generate_catphan504

SKIP = {"date_of_analysis", "pylinac_version"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scan(tmp_path_factory) -> str:
    d = tmp_path_factory.mktemp("catphan")
    generate_catphan504(d, num_slices=60, slice_thickness_mm=2.5)
    return str(d)


@pytest.fixture(scope="module")
def jax_results(scan):
    """JAX ``CatPhanBatch`` and single-scan ``CatPhan504`` on the device
    route, as dicts."""
    pytest.importorskip("jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYLINAC_TPU_CCL", "xla")
        from pylinac_tpu.ct import CatPhan504, CatPhanBatch

        batch = CatPhanBatch([scan])
        batch.analyze()
        single = CatPhan504(scan)
        single.analyze()
        return SimpleNamespace(batch=batch.results_data(as_dict=True)[0],
                               single=single.results_data(as_dict=True), ct=single)


@pytest.fixture(scope="module")
def port(scan):
    batch = tct.CatPhanBatch([scan])
    batch.analyze(device="cpu")
    single = tct.CatPhan504(scan)
    single.analyze(device="cpu")
    return SimpleNamespace(batch=batch, single=single,
                           batch_dict=batch.results_data(as_dict=True)[0],
                           single_dict=single.results_data(as_dict=True))


def _walk(a, b, path=""):
    """(path, a, b) leaf pairs of two result dicts; keys must agree in order."""
    if isinstance(a, dict):
        assert list(a) == list(b), f"{path}: keys {list(a)} != {list(b)}"
        for k in a:
            if k not in SKIP:
                yield from _walk(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _walk(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


def _assert_agree(want: dict, got: dict) -> int:
    n = 0
    for path, a, b in _walk(want, got):
        n += 1
        if isinstance(a, float) and not isinstance(a, bool):
            tol = 0.01 if path.endswith("catphan_roll_deg") else max(0.01, 1e-3 * abs(a))
            assert isinstance(b, float), path
            assert abs(a - b) <= tol, f"{path}: {a} vs {b}"
        else:
            assert a == b and type(a) is type(b), f"{path}: {a!r} vs {b!r}"
    return n


def test_batch_matches_jax(jax_results, port):
    assert _assert_agree(jax_results.batch, port.batch_dict) > 100


def test_single_scan_matches_jax(jax_results, port):
    assert _assert_agree(jax_results.single, port.single_dict) > 100


def test_single_scan_equals_batch(port):
    assert _assert_agree(port.batch_dict, port.single_dict) > 100


@pytest.mark.parametrize("which", ["batch_dict", "single_dict"])
def test_results_within_ct_bars(port, which):
    """``tests/models/test_ct.py:25-74``'s bars on the port's results."""
    r = getattr(port, which)
    assert abs(r["origin_slice"] - 30) <= 1
    assert abs(r["catphan_roll_deg"]) < 0.7
    expected = {"Air": -1000, "PMP": -196, "LDPE": -104, "Poly": -47,
                "Acrylic": 115, "Delrin": 365, "Teflon": 1000}
    for name, nominal in expected.items():
        assert abs(r["ctp404"]["hu_rois"][name]["value"] - nominal) < 12, name
    assert r["ctp404"]["hu_linearity_passed"]
    assert abs(r["ctp404"]["avg_line_distance_mm"] - 50) < 0.5
    assert r["ctp404"]["geometry_passed"]
    assert abs(r["ctp404"]["measured_slice_thickness_mm"] - 2.5) < 0.6
    assert all(abs(roi["value"]) < 10 for roi in r["ctp486"]["rois"].values())
    assert r["ctp486"]["passed"]
    assert r["ctp515"]["num_rois_seen"] >= 2
    assert 0.1 < r["ctp528"]["mtf_lp_mm"]["50"] < 1.5


def test_typed_results(port):
    data = port.batch.results_data()[0]
    assert isinstance(data, tct.CatphanResult)
    assert [f.name for f in dataclasses.fields(data)] == [
        "pylinac_version", "date_of_analysis", "warnings", "catphan_model",
        "catphan_roll_deg", "origin_slice", "num_images", "ctp404", "ctp486",
        "ctp528", "ctp515"]
    assert data.catphan_model == "504" and data.num_images == 60
    assert json.loads(data.model_dump_json())["ctp404"]["offset"] == 0
    as_json = json.loads(port.batch.results_data(as_json=True)[0])
    assert {k: v for k, v in as_json.items() if k != "date_of_analysis"} == \
        {k: v for k, v in port.batch_dict.items() if k != "date_of_analysis"}
    assert "CTP 404 Results" in port.single.results()
    with pytest.raises(ValueError):
        port.single.results_data(as_dict=True, as_json=True)


def test_model_fields_match_jax():
    pytest.importorskip("jax")
    from pylinac_tpu import ct as jct

    for name in ("ROIResult", "CTP404Result", "CTP486Result", "CTP515Result",
                 "CTP528Result", "CatphanResult"):
        port_fields = [f.name for f in dataclasses.fields(getattr(tct, name))]
        assert port_fields == list(getattr(jct, name).model_fields), name


def test_loader_matches_jax(scan, jax_results):
    stack = timage.DicomImageStack(scan)
    ref = jax_results.ct.dicom_stack
    assert len(stack) == len(ref) == 60
    for got, want in zip(stack, ref):
        assert got.array.dtype == want.array.dtype
        np.testing.assert_array_equal(got.array, want.array)
        assert got.z_position == want.z_position
    assert stack.slice_spacing == ref.slice_spacing
    assert stack.metadata.SliceThickness == ref.metadata.SliceThickness


def test_generator_matches_jax(tmp_path):
    pytest.importorskip("jax")
    from pylinac_tpu.core import dcm as jdcm
    from pylinac_tpu.imggen.ct import generate_catphan504 as jgenerate

    kw = dict(num_slices=3, slice_thickness_mm=2.5, image_size=128, mm_per_pixel=2.0)
    got = generate_catphan504(tmp_path / "port", **kw)
    want = jgenerate(tmp_path / "jax", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(timage.DicomImage(g).array, jdcm.dcmread(w).pixel_array
                                      * 1.0 - 1000.0)


def test_mask_stage_is_bit_equal_to_jax(scan, port):
    """The localisation masks of the whole scan against JAX's jitted mask
    stage: 0 of 3,932,160 pooled pixels differ on this scan, although about
    half the edge values differ in their last bit (XLA's fused
    multiply-adds)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from pylinac_tpu.ops.filters import gaussian_filter, scharr
    from pylinac_tpu.ops.threshold import otsu_threshold

    @jax.jit
    def jax_masks(raw):
        n, h, w = raw.shape
        vol = raw.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
        edges = jax.vmap(lambda s: gaussian_filter(scharr(s), 1.0))(vol)
        return edges > jax.vmap(otsu_threshold)(edges)[:, None, None]

    ds, vol = port.single._loc_stage_host()
    assert ds == 2
    want = np.asarray(jax_masks(jnp.asarray(vol)))
    pooled = torch.from_numpy(vol).reshape(60, 256, 2, 256, 2).mean(dim=(2, 4))
    got, _ = tct._mask_batch(pooled, None, 0.0, use_otsu=True, scale08=False)
    assert int((got.numpy() != want).sum()) == 0


def test_localisation_needs_no_overflow_path(port):
    """At most 16 valid regions per pooled slice on this phantom, under
    K = 32: every slice is decided by the batched pass."""
    assert all(c is not None for c in port.single._slice_centroids)


def test_device_none_means_cuda(scan):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        tct.CatPhan504(scan).analyze()
    with pytest.raises(RuntimeError, match="CUDA"):
        tct.CatPhanBatch([scan]).analyze()


def test_not_a_directory(tmp_path):
    with pytest.raises(NotADirectoryError):
        tct.CatPhan504(os.path.join(tmp_path, "missing"))
