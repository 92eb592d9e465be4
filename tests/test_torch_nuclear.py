"""The port's nuclear-medicine suite against the JAX package's, on the CPU.

Both packages read the same multi-frame NM DICOMs, written with the port's
DICOM writer from the recipes of ``tests/models/test_nuclear.py`` (seeded
numpy), and every class runs with several non-default ``analyze``
arguments in one analysis. ``results_data()`` is compared as the
JSON-compatible dict without its date and version: keys, integers and
strings exactly, floats at the parity bar (mm 0.01, % 0.1, others 1e-3
relative). The NEMA smoothing is held bit for bit to
``jax.lax.conv_general_dilated`` on non-integer frames, and the binary
frames and FOV masks of the uniformity analyses exactly. The ``cuda`` test
runs the classes with device work on a card against the CPU:
``python -m pytest --noconftest -m cuda tests/test_torch_nuclear.py``.
"""

import math

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import nuclear as tn
from pylinac_tpu_torch.core import dcm
from pylinac_tpu_torch.ops.filters import smooth3x3

MM_TOL = 0.01
PCT_TOL = 0.1


def write_nm(path, frames, pixel_spacing=4.8, extra=None):
    """A multi-frame NM DICOM of uint16 ``frames`` (the JAX tests' writer)."""
    ds = dcm.Dataset()
    ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.20"
    ds.SOPInstanceUID = dcm.generate_uid()
    ds.StudyInstanceUID = dcm.generate_uid()
    ds.SeriesInstanceUID = dcm.generate_uid()
    ds.Modality = "NM"
    ds.PatientName = "NM^Synthetic"
    ds.PatientID = "NM1"
    ds.PixelSpacing = [pixel_spacing, pixel_spacing]
    for k, v in (extra or {}).items():
        setattr(ds, k, v)
    ds.set_pixel_data(np.asarray(frames).astype(np.uint16))
    dcm.dcmwrite(str(path), ds)
    return str(path)


def gauss2d(shape, cy, cx, sigma, amp):
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    return amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))


def _rotation(direction="CCW", start=10.0, step=12.0):
    item = dcm.Dataset()
    item.RotationDirection = direction
    item.StartAngle = start
    item.AngularStep = step
    return [item]


def write_inputs(d):
    """Every class's input file, at the JAX tests' sizes."""
    rng = np.random.default_rng(2)
    files = {}
    frames = np.ones((10, 32, 32)) * 10
    frames[4] *= 50
    files["mcr"] = write_nm(d / "mcr.dcm", frames)
    # two uniformity frames: one at 4.8 mm, one binned 2 x from 2.4 mm
    a = np.zeros((128, 128))
    a[14:114, 14:114] = 1000 + rng.normal(0, 10, (100, 100))
    files["pu"] = write_nm(d / "pu.dcm", [a, np.roll(a, 3, axis=1)], pixel_spacing=4.8)
    b = np.zeros((256, 256))
    b[30:226, 24:230] = 250 + rng.normal(0, 5, (196, 206))
    files["pu_binned"] = write_nm(d / "pu2.dcm", [b], pixel_spacing=2.4)
    # a point source 1.5 px off the axis of rotation: 30 projections
    cor = []
    for i in range(30):
        ang = np.radians(10 + 12 * i)
        cor.append(gauss2d((64, 64), 32 + 0.7 * np.sin(ang), 32 + 1.5 * np.cos(ang), 2.0, 1000))
    files["cor"] = write_nm(d / "cor.dcm", cor, pixel_spacing=4.0,
                            extra={"RotationInformationSequence": _rotation()})
    res = [gauss2d((64, 64), 31.6, 32.3, 2.0, 1000 * np.exp(-(z - 10) ** 2 / (2 * 3 ** 2)))
           for z in range(20)]
    files["res"] = write_nm(d / "res.dcm", res, pixel_spacing=4.0,
                            extra={"SpacingBetweenSlices": 4.0})
    files["sens"] = write_nm(d / "sens.dcm", [np.full((64, 64), 100)],
                             extra={"ActualFrameDuration": 60000})
    files["sens_bg"] = write_nm(d / "sens_bg.dcm", rng.poisson(3, (3, 64, 64)),
                                extra={"ActualFrameDuration": 30000})
    shape, spacing, sep = (128, 128), 2.0, 80
    arr = np.zeros(shape)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for off in (-sep / spacing / 2, sep / spacing / 2):
        arr += 1000 * np.exp(-((xx - (64 + off)) ** 2) / (2 * 1.5 ** 2))
        arr += 1000 * np.exp(-((yy - (64 + off)) ** 2) / (2 * 1.5 ** 2))
    files["fourbar"] = write_nm(d / "fourbar.dcm", [arr], pixel_spacing=spacing,
                                extra={"Rows": shape[0], "Columns": shape[1]})
    shape = (256, 256)
    arr = np.full(shape, 500.0)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for angle, width in zip((45, -45, -135, 135), (12, 9, 6, 4)):
        cx, cy = 128 + np.cos(np.deg2rad(angle)) * 65, 128 + np.sin(np.deg2rad(angle)) * 65
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < 40 ** 2
        stripes = 500 + 400 * np.sign(np.sin(2 * np.pi * xx / (2 * width / 2.0)))
        arr[mask] = stripes[mask]
    files["quad"] = write_nm(d / "quad.dcm", [arr], pixel_spacing=2.0,
                             extra={"Rows": shape[0], "Columns": shape[1]})
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:128, :128]
    disk = (yy - 64) ** 2 + (xx - 64) ** 2 < 50 ** 2
    tu = [np.clip(np.where(disk, 1000.0, 0.0) + rng.normal(0, 10, (128, 128)), 0, None)
          for _ in range(10)]
    files["tu"] = write_nm(d / "tu.dcm", tu, pixel_spacing=4.8)
    files["tc"] = write_nm(d / "tc.dcm", jaszczak(), pixel_spacing=2.4)
    return files


def jaszczak(n_slices=16, size=128, spacing=2.4, sphere_slice=11, seed=9):
    """The JAX test's cold-sphere cylinder: a hot cylinder whose radius
    jitters by slice, six cold spheres at the analysis's own placement."""
    rng = np.random.default_rng(seed)
    c = size / 2
    yy, xx = np.mgrid[:size, :size]
    frames = np.array([
        np.where((yy - c) ** 2 + (xx - c) ** 2 < (55 + rng.uniform(-1, 1)) ** 2, 1000.0, 0.0)
        + rng.normal(0, 5, (size, size)).clip(-20, 20) for _ in range(n_slices)]).clip(0)
    dist_px = (55 - 11) * 0.65
    zz, yy3, xx3 = np.mgrid[:n_slices, :size, :size]
    for angle, diam in zip((-10, -70, -130, -190, 110, 50), (38, 31.8, 25.4, 19.1, 15.9, 12.7)):
        cx = c + np.cos(np.deg2rad(angle)) * dist_px
        cy = c + np.sin(np.deg2rad(angle)) * dist_px
        r_px = diam / (2 * spacing)
        frames[(xx3 - cx) ** 2 + (yy3 - cy) ** 2 + (zz - sphere_slice) ** 2 <= r_px ** 2] = 300.0
    return frames


# (class, file, analyze arguments): several non-default arguments each
CASES = {
    "MaxCountRate": ("mcr", {"frame_duration": 2.0}),
    "PlanarUniformity": ("pu", {"ufov_ratio": 0.9, "cfov_ratio": 0.7, "window_size": 4,
                                "threshold": 0.7}),
    "PlanarUniformity binned": ("pu_binned", {"ufov_ratio": 0.92, "window_size": 6}),
    "CenterOfRotation": ("cor", {}),
    "TomographicResolution": ("res", {}),
    "FourBarResolution": ("fourbar", {"separation_mm": 80, "roi_width_mm": 12}),
    "QuadrantResolution": ("quad", {"bar_widths": (12, 9, 6, 4), "roi_diameter_mm": 50,
                                    "distance_from_center_mm": 100}),
    "TomographicUniformity": ("tu", {"first_frame": 1, "last_frame": 8, "ufov_ratio": 0.85,
                                     "cfov_ratio": 0.7, "center_ratio": 0.35,
                                     "threshold": 0.7, "window_size": 4}),
    "TomographicContrast": ("tc", {"search_window_px": 4, "search_slices": 2,
                                   "ufov_ratio": 0.82}),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("nm"))


@pytest.fixture(scope="module")
def jnm():
    pytest.importorskip("jax")
    import pylinac_tpu.nuclear as jn

    return jn


def _run(module, name, path, device=None, **kwargs):
    cls = getattr(module, name.split()[0])
    obj = cls(path)
    if device is None:
        obj.analyze(**kwargs)
    else:
        obj.analyze(**kwargs, device=device)
    return obj, _strip(obj.results_data(as_dict=True))


def _strip(data):
    if isinstance(data, dict):
        return {k: _strip(v) for k, v in data.items()
                if k not in ("date_of_analysis", "pylinac_version")}
    return data


def _tol(key: str, a: float) -> float:
    if "uniformity" in key or "difference" in key or "contrast" in key or key == "mtf":
        return PCT_TOL
    if "fwhm" in key or "fwtm" in key or "deviation" in key or "pixel_size" in key \
            or key in ("x", "y", "z", "radius", "spacing"):
        return MM_TOL
    return 1e-3 * max(abs(a), 1.0)


def assert_same(port, ref, path=""):
    assert type(port) is type(ref) or (isinstance(port, (int, float))
                                       and isinstance(ref, (int, float))), path
    if isinstance(ref, dict):
        assert list(port) == list(ref), path
        for k in ref:
            assert_same(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, float):
        key = path.rsplit(".", 1)[-1]
        assert math.isclose(port, ref, rel_tol=0, abs_tol=_tol(key, ref)), (path, port, ref)
    else:
        assert port == ref, (path, port, ref)


@pytest.fixture(scope="module")
def analyses(files, jnm):
    """Each case analysed once by each package: (port object, port dict,
    JAX object, JAX dict)."""
    out = {}
    for name, (key, kwargs) in CASES.items():
        port = _run(tn, name, files[key], device="cpu", **kwargs)
        ref = _run(jnm, name, files[key], **kwargs)
        out[name] = (*port, *ref)
    sens = {}
    for mod, dev in ((tn, "cpu"), (jnm, None)):
        s = mod.SimpleSensitivity(files["sens"], background_path=files["sens_bg"])
        kw = {"activity_mbq": 50, "nuclide": mod.Nuclide.I131}
        s.analyze(**kw) if dev is None else s.analyze(**kw, device=dev)
        sens[mod] = _strip(s.results_data(as_dict=True))
    out["SimpleSensitivity"] = (None, sens[tn], None, sens[jnm])
    return out


@pytest.mark.parametrize("name", [*CASES, "SimpleSensitivity"])
def test_results_match_jax(analyses, name):
    _, port, _, ref = analyses[name]
    assert_same(port, ref, name)


def test_results_text_and_geometry(analyses):
    """The text reports agree where they print only exact numbers, and the
    drawn geometry is met: the COR offset, the point source's FWHM, the
    spheres' contrast."""
    pu, _, jpu, _ = analyses["PlanarUniformity"]
    assert pu.results() == jpu.results()
    cor, cor_data = analyses["CenterOfRotation"][:2]
    # 1.5 px at 4 mm off the axis: a sinusoid of 6 mm, which the fit takes whole
    assert abs(cor.cor_x["b"]) == pytest.approx(6.0, abs=0.05)
    assert cor_data["x_deviation_mm"] < 0.05
    res = analyses["TomographicResolution"][1]
    assert res["x_fwhm"] == pytest.approx(2.3548 * 2 * 4, rel=0.05)
    tc = analyses["TomographicContrast"][1]
    assert len(tc["spheres"]) == 6 and tc["spheres"]["1"]["mean_contrast"] > 40


@pytest.mark.parametrize("shape", [(128, 128), (37, 41), (3, 3), (1, 50), (256, 64)])
def test_smoothing_matches_xla_bit_for_bit(jnm, shape):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(sum(shape))
    a = (rng.standard_normal(shape) * 300 + 100).astype(np.float32)
    a[rng.random(shape) < 0.2] = 0
    kernel = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], float) / 16
    want = np.array(jax.lax.conv_general_dilated(
        jnp.asarray(a)[None, None], jnp.asarray(kernel, jnp.float32)[None, None],
        window_strides=(1, 1), padding="SAME"))[0, 0]
    got = smooth3x3(torch.from_numpy(a)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_binary_frames_and_fovs_exact(analyses, jnm):
    """The cleaned frames and the UFOV, CFOV and centre masks of the planar
    and tomographic uniformity analyses equal JAX's exactly (non-integer
    mean frames in the tomographic case)."""
    for name in ("PlanarUniformity", "PlanarUniformity binned", "TomographicUniformity"):
        port, _, ref, _ = analyses[name]
        for key in ref.frame_results:
            p, r = port.frame_results[key], ref.frame_results[key]
            assert np.array_equal(p["binned_frame"], r["binned_frame"]), (name, key)
            for fov in ("ufov", "cfov", "center_fov"):
                if fov in r:
                    assert np.array_equal(p[fov].fov, r[fov].fov), (name, key, fov)
                    assert np.array_equal(p[fov].boundary_x, r[fov].boundary_x)
                    assert np.array_equal(p[fov].boundary_y, r[fov].boundary_y)
    tc, _, jtc, _ = analyses["TomographicContrast"]
    assert list(tc.slice_data) == list(jtc.slice_data)
    for k, v in jtc.slice_data.items():
        assert tc.slice_data[k]["area"] == v["area"]
        assert tc.slice_data[k]["fov diameter"] == v["fov diameter"]
        assert tc.slice_data[k]["uniformity"] == v["uniformity"]


def test_errors_and_stubs(files):
    q = tn.QuadrantResolution(files["mcr"])
    with pytest.raises(ValueError, match="4 bar widths"):
        q.analyze(bar_widths=(1, 2, 3), device="cpu")
    tu = tn.TomographicUniformity(files["tu"])
    with pytest.raises(ValueError):
        tu.analyze(first_frame=4, last_frame=2, device="cpu")
    with pytest.raises(AttributeError, match="sums"):  # not analysed, as in JAX
        tn.MaxCountRate(files["mcr"]).plot(show=False)
    assert tn.determine_binning(1.2) == 4
    assert tn.fwhm_from_gaussian(-1.0) == pytest.approx(2.3548, abs=1e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tn.MaxCountRate(files["mcr"]).analyze()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["PlanarUniformity", "PlanarUniformity binned",
                                  "CenterOfRotation", "TomographicResolution",
                                  "FourBarResolution", "TomographicUniformity",
                                  "TomographicContrast"])
def test_card_matches_cpu(cuda, files, name):
    """The classes with device work on the card against the CPU: integers
    and masks exactly, floats at the bar; the smoothing, the morphology and
    the region searches give the same frames."""
    key, kwargs = CASES[name]
    card, card_data = _run(tn, name, files[key], device="cuda", **kwargs)
    cpu, cpu_data = _run(tn, name, files[key], device="cpu", **kwargs)
    assert_same(card_data, cpu_data, name)
    for k, r in getattr(cpu, "frame_results", {}).items():
        assert np.array_equal(card.frame_results[k]["binned_frame"], r["binned_frame"])
        assert np.array_equal(card.frame_results[k]["ufov"].fov, r["ufov"].fov)
