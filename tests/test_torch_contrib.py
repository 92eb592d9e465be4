"""The port's contributed analyses against the JAX package's, on the CPU.

``JawOrthogonality``: the Canny edge map of the stretched frame and the
3600-angle Hough accumulator equal JAX's, and the four corner angles agree
within 1e-9 degrees. ``hough_line`` (one ``bincount`` in the port, JAX's
``np.add.at``) gives JAX's counts on those edges and on seeded masks.
``QuasarLightRadScaling``: ``results_data()`` and the five scaling centres
at the parity bar, warnings included. The frames are the JAX tests' own
recipes (``tests/models/test_contrib.py``), drawn once a module by JAX's
generator; the Quasar frame on an AS500 rather than the recipe's AS1000 (its
mm sizes kept), which keeps JAX's FC-2 analysis of each argument set short.
The ``cuda`` tests hold the card to the CPU:
``python -m pytest --noconftest -m cuda tests/test_torch_contrib.py``.
"""

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.contrib.orthogonality import JawOrthogonality
from pylinac_tpu_torch.contrib.quasar import QuasarLightRadScaling
from pylinac_tpu_torch.planar_imaging import hough_line, hough_line_peaks

QUASAR_CORNERS = ((-49, -49), (-49, 49), (49, -49), (49, 49))
QUASAR_SCALING = ((0, 0), (-12, 0), (12, 0), (0, -12), (0, 12))


def draw_orthogonality(layers, sim_cls, path, field_mm=(100, 100), sigma_mm=0.5):
    """An open field as ``tests/models/test_contrib.py`` draws it, with
    either package's ``imggen.layers`` and simulator class."""
    sim = sim_cls(sid=1000)
    sim.add_layer(layers.FilteredFieldLayer(field_size_mm=field_mm))
    sim.add_layer(layers.GaussianFilterLayer(sigma_mm=sigma_mm))
    sim.generate_dicom(str(path))
    return str(path)


def draw_quasar(layers, sim_cls, path):
    """The Quasar frame of ``tests/models/test_contrib.py:30-50``."""
    sim = sim_cls(sid=1000)
    sim.add_layer(layers.FilteredFieldLayer(field_size_mm=(120, 120)))
    for pos in QUASAR_CORNERS + QUASAR_SCALING:
        sim.add_layer(layers.PerfectBBLayer(bb_size_mm=5, cax_offset_mm=pos))
    sim.add_layer(layers.GaussianFilterLayer(sigma_mm=0.5))
    sim.generate_dicom(str(path))
    return str(path)


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pylinac_tpu import planar_imaging as jplanar
    from pylinac_tpu.contrib.orthogonality import JawOrthogonality as JJaw
    from pylinac_tpu.contrib.quasar import QuasarLightRadScaling as JQuasar
    from pylinac_tpu.core.array_utils import stretch
    from pylinac_tpu.imggen import layers, simulators
    from pylinac_tpu.ops.edges import canny

    def edges(image):
        return np.asarray(canny(jnp.asarray(stretch(image.array), jnp.float32)))

    return {"Jaw": JJaw, "Quasar": JQuasar, "planar": jplanar, "layers": layers,
            "sims": simulators, "edges": edges}


@pytest.fixture(scope="module")
def frames(jax_side, tmp_path_factory):
    d = tmp_path_factory.mktemp("contrib")
    layers, sims = jax_side["layers"], jax_side["sims"]
    return {"square": draw_orthogonality(layers, sims.AS1000Image, d / "square.dcm"),
            "oblong": draw_orthogonality(layers, sims.AS500Image, d / "oblong.dcm",
                                         field_mm=(60, 120), sigma_mm=1),
            "quasar": draw_quasar(layers, sims.AS500Image, d / "quasar.dcm")}


_JAW = {}


def _jaw_pair(jax_side, path):
    """(port analysis, JAX analysis, JAX's edge map) of one frame, once a
    module."""
    if path not in _JAW:
        port = JawOrthogonality(path)
        port.analyze(device="cpu")
        ref = jax_side["Jaw"](path)
        ref.analyze()
        _JAW[path] = port, ref, jax_side["edges"](ref.image)
    return _JAW[path]


@pytest.mark.parametrize("frame", ["square", "oblong"])
def test_jaw_edges_and_hough_equal_jax(jax_side, frames, frame):
    port, ref, ref_edges = _jaw_pair(jax_side, frames[frame])
    assert port.edge_image.dtype == ref_edges.dtype == np.bool_
    assert np.array_equal(port.edge_image, ref_edges)
    theta = np.linspace(-np.pi / 2, np.pi / 2, num=3600, endpoint=False)
    h, _, _ = jax_side["planar"].hough_line(ref_edges, theta=theta)
    assert port.hspace.dtype == h.dtype == np.uint64
    assert np.array_equal(port.hspace, h)


@pytest.mark.parametrize("frame", ["square", "oblong"])
def test_jaw_angles_match_jax(jax_side, frames, frame):
    port, ref, _ = _jaw_pair(jax_side, frames[frame])
    a, b = port.results(), ref.results()
    assert list(a) == list(b) == ["top_left", "top_right", "bottom_left", "bottom_right"]
    for key in b:
        assert abs(a[key] - b[key]) <= 1e-9, key
        if frame == "square":  # the oblong field's peaks pair two parallel edges
            assert a[key] == pytest.approx(90, abs=0.5), key
    assert {k: (v["angle"], v["dist"]) for k, v in port.line_angles.items()} == \
           {k: (v["angle"], v["dist"]) for k, v in ref.line_angles.items()}


@pytest.mark.parametrize("seed,shape,n_theta,density", [
    (0, (40, 70), 181, 0.05), (1, (97, 31), 3600, 0.2), (2, (8, 8), 5, 1.0),
    (3, (50, 50), 360, 0.0)])
def test_hough_line_counts_equal_jax(jax_side, seed, shape, n_theta, density):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < density
    theta = np.sort(rng.uniform(-np.pi / 2, np.pi / 2, n_theta))
    got = hough_line(mask, theta=theta)
    want = jax_side["planar"].hough_line(mask, theta=theta)
    assert got[0].dtype == want[0].dtype == np.uint64
    assert np.array_equal(got[0], want[0]) and got[0].sum() == mask.sum() * n_theta
    assert np.array_equal(got[2], want[2])
    for a, b in zip(hough_line_peaks(*got, num_peaks=4),
                    jax_side["planar"].hough_line_peaks(*want, num_peaks=4)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("analyze", [
    {}, {"fwxm": 60, "bb_edge_threshold_mm": 20}, {"invert": True, "fwxm": 40}])
def test_quasar_matches_jax(jax_side, frames, analyze):
    port = QuasarLightRadScaling(frames["quasar"])
    ref = jax_side["Quasar"](frames["quasar"])
    outcomes = []
    for obj, kw in ((port, {"device": "cpu"}), (ref, {})):
        try:
            obj.analyze(**analyze, **kw)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    if outcomes[0] is not None:
        return
    a, b = port.results_data(as_dict=True), ref.results_data(as_dict=True)
    a.pop("date_of_analysis"), b.pop("date_of_analysis")
    assert [(w["message"], w["category"]) for w in a.pop("warnings")] == \
           [(w["message"], w["category"]) for w in b.pop("warnings")]
    assert list(a) == list(b)
    for key in b:
        if isinstance(b[key], float):
            assert a[key] == pytest.approx(b[key], abs=1e-4), key
        else:
            assert a[key] == b[key], key
    assert len(port.scaling_centers) == 5
    for p, q in zip(port.scaling_centers, ref.scaling_centers):
        assert abs(p.x - q.x) <= 1e-3 and abs(p.y - q.y) <= 1e-3
    assert port.results() == ref.results()
    if not analyze:
        assert a["field_size_x_mm"] == pytest.approx(120, abs=2)
        assert abs(a["field_bb_offset_x_mm"]) < 1.5


def test_reports_and_device(frames):
    jaw = JawOrthogonality(frames["square"])
    with pytest.raises(AttributeError, match="line_angles"):  # not analysed, as in JAX
        jaw.plot_analyzed_image(show=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            jaw.analyze()
        with pytest.raises(RuntimeError, match="CUDA"):
            QuasarLightRadScaling(frames["quasar"]).analyze()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_jaw_and_quasar_equal_cpu(cuda, tmp_path):
    """Frames drawn by the port's own generator (no JAX on the card)."""
    from pylinac_tpu_torch.imggen import layers
    from pylinac_tpu_torch.imggen.simulators import AS1000Image

    square = draw_orthogonality(layers, AS1000Image, tmp_path / "square.dcm")
    card, cpu = JawOrthogonality(square), JawOrthogonality(square)
    card.analyze(device=cuda)
    cpu.analyze(device="cpu")
    assert np.array_equal(card.edge_image, cpu.edge_image)
    assert np.array_equal(card.hspace, cpu.hspace)
    assert card.results() == cpu.results()
    quasar = draw_quasar(layers, AS1000Image, tmp_path / "quasar.dcm")
    card, cpu = QuasarLightRadScaling(quasar), QuasarLightRadScaling(quasar)
    card.analyze(device=cuda)
    cpu.analyze(device="cpu")
    a, b = card.results_data(as_dict=True), cpu.results_data(as_dict=True)
    for key in ("field_size_x_mm", "field_size_y_mm", "field_bb_offset_x_mm",
                "field_bb_offset_y_mm"):
        assert a[key] == pytest.approx(b[key], abs=0.01), key
    for p, q in zip(card.scaling_centers, cpu.scaling_centers):
        assert abs(p.x - q.x) <= 1e-3 and abs(p.y - q.y) <= 1e-3
