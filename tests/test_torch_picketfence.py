"""The port's batched picket fence, end to end, against the JAX package's.

Both load the same DICOM files (made by the JAX image generator) and run
``analyze_batch``; the port runs on the CPU with its plain twins. Every
``PFResult`` field is compared. Tolerances, the repo's parity bar
(BASELINE.json): integers, flags, leaf keys and leaf lists exact; mm fields
(and the skew, in degrees) within 0.01; percentages within 0.1 %.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pylinac_tpu.core import image as jimage
from pylinac_tpu.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
from pylinac_tpu.imggen.simulators import AS1200Image
from pylinac_tpu.imggen.utils import generate_picketfence
from pylinac_tpu.picketfence import PFResult as JaxPFResult
from pylinac_tpu.picketfence import PicketFenceBatch as JaxBatch
from pylinac_tpu.picketfence import analyze_batch as jax_analyze_batch
from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.picketfence import PFResult, PicketFenceBatch, analyze_batch

MM_TOL = 0.01
PCT_TOL = 0.1
MM_FIELDS = ("absolute_median_error_mm", "max_error_mm", "mean_picket_spacing_mm",
             "mlc_skew", "tolerance_mm")
EXACT_FIELDS = ("pylinac_version", "warnings", "action_tolerance_mm", "number_of_pickets",
                "max_error_picket", "max_error_leaf", "passed", "failed_leaves", "cax")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pf_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pf")
    paths = []
    for i, err in enumerate(([0] * 10, [0, 0, 0.4, 0, 0, 0, 0, 0, 0, 0])):
        path = str(tmp / f"pf{i}.dcm")
        generate_picketfence(
            simulator=AS1200Image(sid=1500), field_layer=PerfectFieldLayer, file_out=path,
            final_layers=[GaussianFilterLayer(sigma_mm=1)],
            pickets=10, picket_spacing_mm=20, picket_width_mm=3,
            picket_offset_error=list(err))
        paths.append(path)
    return paths


def _spiked(arrays, seed=3):
    """EPID-like uint16 frames: raw x0.5 plus a 1000-count dark offset,
    sigma-2 count noise and 0.01 % hot pixels at 65535."""
    rng = np.random.default_rng(seed)
    out = []
    for a in arrays:
        noisy = a.astype(np.float64) * 0.5 + 1000 + rng.normal(0, 2, a.shape).round()
        noisy = np.clip(noisy, 0, 65535)
        noisy.flat[rng.choice(a.size, a.size // 10000, replace=False)] = 65535
        out.append(noisy.astype(np.uint16))
    return out


def _assert_results_match(t: PFResult, j: JaxPFResult):
    assert [f.name for f in dataclasses.fields(t)] == list(type(j).model_fields)
    for name in EXACT_FIELDS:
        assert getattr(t, name) == getattr(j, name), name
    for name in MM_FIELDS:
        assert getattr(t, name) == pytest.approx(getattr(j, name), abs=MM_TOL), name
    assert t.percent_leaves_passing == pytest.approx(j.percent_leaves_passing, abs=PCT_TOL)
    np.testing.assert_allclose(t.offsets_from_cax_mm, j.offsets_from_cax_mm, rtol=0, atol=MM_TOL)
    assert list(t.picket_widths) == list(j.picket_widths)
    for picket, stats in t.picket_widths.items():
        assert list(stats) == list(j.picket_widths[picket])
        for k, v in stats.items():
            assert v == pytest.approx(j.picket_widths[picket][k], abs=MM_TOL), (picket, k)
    for name in ("mlc_positions_by_leaf", "mlc_errors_by_leaf"):
        tv, jv = getattr(t, name), getattr(j, name)
        assert list(tv) == list(jv), name
        for leaf in tv:
            np.testing.assert_allclose(tv[leaf], jv[leaf], rtol=0, atol=MM_TOL, err_msg=name)


@pytest.mark.parametrize("separate_leaves", [False, True])
def test_analyze_batch_matches_jax(pf_files, separate_leaves):
    kwargs = dict(tolerance=0.5, separate_leaves=separate_leaves, nominal_gap_mm=3)
    want = jax_analyze_batch(pf_files, **kwargs)
    got = analyze_batch(pf_files, device="cpu", **kwargs)
    assert len(got) == len(want) == 2
    for t, j in zip(got, want):
        _assert_results_match(t, j)
    assert all(r.number_of_pickets == 10 for r in got)


def test_spiked_noisy_batch_matches_jax(pf_files):
    jb = JaxBatch(pf_files)
    tb = PicketFenceBatch(pf_files)
    for jim, tim, arr in zip(jb.images, tb.images, _spiked([im.array for im in jb.images])):
        jim.array = arr
        tim.array = arr.copy()
    jb.analyze(tolerance=0.5)
    tb.analyze(tolerance=0.5, device="cpu")
    assert tb._out["despike_passes"].tolist() == [1, 1]
    for t, j in zip(tb.results_data(), jb.results_data()):
        _assert_results_match(t, j)
    # the 0.4 mm offset of the third picket shows in its distance to the CAX
    results = tb.results_data()
    shift = results[1].offsets_from_cax_mm[2] - results[0].offsets_from_cax_mm[2]
    assert abs(shift) == pytest.approx(0.4, abs=0.05)


def test_results_data_dict_and_json_keys_match_jax(pf_files):
    jb = JaxBatch(pf_files)
    jb.analyze(tolerance=0.5)
    tb = PicketFenceBatch(pf_files)
    tb.analyze(tolerance=0.5, device="cpu")
    assert list(tb.results_data(as_dict=True)[0]) == list(jb.results_data(as_dict=True)[0])
    t_json = json.loads(tb.results_data(as_json=True)[0])
    j_json = json.loads(jb.results_data(as_json=True)[0])
    assert list(t_json) == list(j_json)
    assert t_json["failed_leaves"] == j_json["failed_leaves"]
    assert t_json["mlc_errors_by_leaf"].keys() == j_json["mlc_errors_by_leaf"].keys()


def test_loader_matches_jax(pf_files):
    for path in pf_files:
        j = jimage.LinacDicomImage(path)
        t = timage.LinacDicomImage(path)
        assert t.array.dtype == j.array.dtype
        np.testing.assert_array_equal(t.array, j.array)
        assert t.dpmm == j.dpmm
        assert t.sid == j.sid
        assert t.center.dict() == j.center.dict()
    for j, t in zip(JaxBatch(pf_files).images, PicketFenceBatch(pf_files).images):
        np.testing.assert_array_equal(t.array, j.array)


def test_analyze_without_device_needs_cuda(pf_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PicketFenceBatch(pf_files[:1]).analyze()
