"""The port's Winston-Lutz analyses against the JAX package's.

Two generated 4-frame sessions (gantry 0, 90, 180, 270; 30 mm field, 5 mm
BB 0.5 mm left and 0.3 mm up of the isocentre, 1 mm blur): AS500 frames
(384 x 512, 1.28 px/mm at SID 1000) and AS1200 frames (1280 x 1280, 2.976
px/mm, the bench's frame). Both packages analyse the same DICOM files, the
port on the CPU. A third AS500 session adds an 'in' offset of -0.4 mm,
and 24 seeded ray sets hold the isocentre fit to JAX's bit for bit.

Tolerance: every float of ``results_data()`` within 0.01 (mm, and px for
the point fields), integers, strings, keys and types exact. The detections
and the Nelder-Mead isocentre fits agree to the last bit here.

The selectors: JAX's ``PYLINAC_TPU_FLOOD=packed`` calls the Pallas kernel
without interpret mode (``winston_lutz.py:493``), which does not lower on
the CPU; the port's ``packed`` run is then held against JAX's ``xla`` run,
the same exact fill. On the AS1200 session both exact selectors are held
against JAX's default (convex) run, to keep the file near a minute: the
fields are convex, so the fills agree (``tests/ops/test_label_batch.py``
shows it for JAX), and each port selector's field centres are also held
bit for bit against the port's default run.
"""

import math
import os

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import BBArrangement, MachineScale, WinstonLutz, WinstonLutz2D
from pylinac_tpu_torch import winston_lutz as twl
from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
from pylinac_tpu_torch.imggen.simulators import AS500Image, AS1200Image
from pylinac_tpu_torch.imggen.utils import generate_winstonlutz
from pylinac_tpu_torch.metrics import features
from pylinac_tpu_torch.ops import flood

TOL = 0.01
AXES_4 = ((0, 0, 0), (90, 0, 0), (180, 0, 0), (270, 0, 0))
SIMULATORS = {"AS500": AS500Image, "AS1200": AS1200Image}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _generate(d: str, sim, **kwargs) -> str:
    generate_winstonlutz(sim(sid=1000), PerfectFieldLayer, d,
                         final_layers=[GaussianFilterLayer(sigma_mm=1)], **kwargs)
    return d


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    return {name: _generate(str(tmp_path_factory.mktemp(name) / "wl"), sim, image_axes=AXES_4,
                            offset_mm_left=0.5, offset_mm_up=0.3)
            for name, sim in SIMULATORS.items()}


@pytest.fixture(scope="module")
def jwl():
    pytest.importorskip("jax")
    from pylinac_tpu import winston_lutz

    return winston_lutz


@pytest.fixture(scope="module")
def port_results(sessions):
    """The port's results of a session under a selector, computed once."""
    cache = {}

    def get(name: str, mode: str) -> tuple[dict, str]:
        if (name, mode) not in cache:
            wl = _port(sessions[name], mode)
            cache[name, mode] = (wl.results_data(as_dict=True), wl.results())
        return cache[name, mode]

    return get


@pytest.fixture(scope="module")
def jax_results(jwl, sessions):
    """JAX results of a session under a selector, computed once."""
    cache = {}

    def get(name: str, mode: str) -> dict:
        if (name, mode) not in cache:
            with twl.flood_selector(mode):
                wl = jwl.WinstonLutz(sessions[name])
                wl.analyze()
            cache[name, mode] = (wl.results_data(as_dict=True), wl.results())
        return cache[name, mode]

    return get


def _port(directory: str, mode: str = "", **analyze) -> WinstonLutz:
    with twl.flood_selector(mode):
        wl = WinstonLutz(directory)
        wl.analyze(device="cpu", **analyze)
    return wl


def assert_same(port, ref, path: str = "") -> None:
    """Keys, types, integers and strings exact; floats within TOL."""
    if isinstance(ref, dict):
        assert list(port) == list(ref), path
        for key in ref:
            if key != "date_of_analysis":
                assert_same(port[key], ref[key], f"{path}/{key}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f"{path}[{i}]")
    else:
        assert type(port) is type(ref), (path, port, ref)
        if isinstance(ref, float):
            assert abs(port - ref) <= TOL, (path, port, ref)
        else:
            assert port == ref, (path, port, ref)


@pytest.mark.parametrize("mode", ["", "xla", "packed"])
@pytest.mark.parametrize("name", list(SIMULATORS))
def test_batch_matches_jax(port_results, jax_results, name, mode):
    got, text = port_results(name, mode)
    ref_mode = "" if name == "AS1200" else ("xla" if mode == "packed" else mode)
    want, want_text = jax_results(name, ref_mode)
    assert_same(got, want)
    assert text == want_text
    # the selectors' field centres agree to the last bit on convex fields
    for a, b in zip(got["image_details"], port_results(name, "")[0]["image_details"]):
        assert a["field_cax"] == b["field_cax"]


def test_packed_selector_does_not_lower_on_jax_cpu(jwl, sessions):
    """Why ``packed`` is held against JAX's ``xla`` run."""
    with twl.flood_selector("packed"), pytest.raises(ValueError, match="interpret"):
        jwl.WinstonLutz(sessions["AS500"]).analyze()


@pytest.mark.parametrize("name", list(SIMULATORS))
def test_single_image_matches_jax(jwl, port_results, sessions, name):
    """``WinstonLutz2D`` on the gantry-90 frame: the exact field fill (the
    flood twin on the CPU) and the sequential BB finder, one threshold at a
    time."""
    path = os.path.join(sessions[name], next(
        f for f in os.listdir(sessions[name]) if f.startswith("WL G=90,")))
    img = WinstonLutz2D(path)
    img.analyze(device="cpu")
    ref = jwl.WinstonLutz2D(path)
    ref.analyze()
    assert_same(img.results_data(as_dict=True), ref.results_data(as_dict=True))
    # and the batch, sorted by gantry angle, agrees with the single image
    assert_same(img.results_data(as_dict=True), port_results(name, "")[0]["image_details"][1])


def test_custom_conditions_take_the_per_image_route(jwl, sessions):
    """Custom detection conditions decline the batched detection: the
    fields go through the batched fill, the BBs through the per-image
    finder, with each package's own predicates."""
    class Port(WinstonLutz):
        detection_conditions = [features.is_right_size_bb, features.is_round,
                                features.is_right_circumference, features.is_symmetric,
                                features.is_solid, features.is_near_center]

    class Ref(jwl.WinstonLutz):
        detection_conditions = [jwl.is_right_size_bb, jwl.is_round, jwl.is_right_circumference,
                                jwl.is_symmetric, jwl.is_solid, jwl.is_near_center]

    port = Port(sessions["AS500"])
    port.analyze(device="cpu")
    assert not hasattr(port, "_bb_scan_cache")
    ref = Ref(sessions["AS500"])
    ref.analyze()
    assert_same(port.results_data(as_dict=True), ref.results_data(as_dict=True))


def test_session_inside_the_bars(sessions):
    """``tests/models/test_winstonlutz.py``'s bars for the generated offset
    (left 0.5, up 0.3 mm): the shift is RIGHT 0.5 and DOWN 0.3 mm."""
    wl = _port(sessions["AS500"])
    data = wl.results_data()
    sv = data.bb_shift_vector
    assert abs(sv["x"] - 0.5) < 0.3 and abs(sv["y"]) < 0.3 and abs(sv["z"] + 0.3) < 0.3
    assert data.gantry_3d_iso_diameter_mm < 0.3
    assert abs(data.max_2d_cax_to_bb_mm - math.hypot(0.5, 0.3)) < 0.3
    assert data.num_total_images == 4 and len(data.image_details) == 4
    assert list(data.keyed_image_details) == ["G0B0P0", "G90B0P0", "G180B0P0", "G270B0P0"]
    assert isinstance(data.image_details[0], twl.WinstonLutz2DResult)
    dumped = data.model_dump()
    assert dumped["image_details"][0]["bb_location"] == data.image_details[0].bb_location
    assert "Winston-Lutz Analysis" in wl.results()


@pytest.mark.parametrize("offsets, want", [
    ({"offset_mm_left": 2}, (2, 0, 0)),
    ({"offset_mm_up": 3, "offset_mm_in": 1}, (0, -1, -3)),
])
def test_offset_bars(tmp_path, offsets, want):
    """``test_offset_bb_left`` and ``test_offset_bb_up_and_in`` on AS500
    frames."""
    wl = _port(_generate(str(tmp_path / "wl"), AS500Image, image_axes=AXES_4, **offsets))
    sv = wl.bb_shift_vector
    assert abs(sv.x - want[0]) < 0.3 and abs(sv.y - want[1]) < 0.3 and abs(sv.z - want[2]) < 0.3


def test_perfect_set_with_collimator_and_couch(tmp_path):
    """``test_perfect_wl``'s bars on nine AS500 frames."""
    axes = ((0, 0, 0), (45, 0, 0), (90, 0, 0), (180, 0, 0), (270, 0, 0),
            (0, 45, 0), (0, 90, 0), (0, 0, 45), (0, 0, 90))
    data = _port(_generate(str(tmp_path / "wl"), AS500Image, image_axes=axes)).results_data()
    assert data.max_2d_cax_to_bb_mm < 0.25
    assert data.gantry_3d_iso_diameter_mm < 0.3
    assert data.coll_2d_iso_diameter_mm < 0.3
    assert data.couch_2d_iso_diameter_mm < 0.3
    assert (data.num_coll_images, data.num_couch_images) == (3, 3)
    assert all(abs(v) < 0.2 for v in (data.bb_shift_vector[k] for k in "xyz"))


def test_virtual_shift_and_repeat_analyze(sessions):
    wl = _port(sessions["AS500"])
    first = wl.results_data(as_dict=True)
    wl.analyze(device="cpu")  # cached BB scan, staged frames
    assert_same(wl.results_data(as_dict=True), first)
    wl.analyze(device="cpu", apply_virtual_shift=True)
    assert "Virtual shift applied" in wl.results()
    assert wl.cax2bb_distance("max") < first["max_2d_cax_to_bb_mm"]


def test_no_cuda_raises_without_device(sessions):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        WinstonLutz(sessions["AS500"]).analyze()
    path = os.path.join(sessions["AS500"], os.listdir(sessions["AS500"])[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        WinstonLutz2D(path).analyze()


@pytest.mark.parametrize("before", [None, "xla"])
def test_flood_selector_restores_the_variable(monkeypatch, before):
    if before is None:
        monkeypatch.delenv("PYLINAC_TPU_FLOOD", raising=False)
    else:
        monkeypatch.setenv("PYLINAC_TPU_FLOOD", before)
    with pytest.raises(KeyError), twl.flood_selector("packed"):
        assert os.environ["PYLINAC_TPU_FLOOD"] == "packed"
        raise KeyError
    assert os.environ.get("PYLINAC_TPU_FLOOD") == before


def test_helpers_match_jax(jwl):
    for args in ((0.5, 0.3, 1.0, 90, 0), (-1, 2, 0, 45, 270), (0, 0, 3, 180, 90)):
        np.testing.assert_array_equal(twl.bb_projection_with_rotation(*args),
                                      jwl.bb_projection_with_rotation(*args))
    scale = MachineScale.VARIAN_STANDARD
    v = twl.solve_3d_shift_vector_from_2d_planes([0.1, -0.2, 0.3], [0.2, 0.1, -0.1],
                                                 [0, 90, 180], [0, 0, 45], scale)
    jv = jwl.solve_3d_shift_vector_from_2d_planes([0.1, -0.2, 0.3], [0.2, 0.1, -0.1],
                                                  [0, 90, 180], [0, 0, 45],
                                                  jwl.MachineScale.VARIAN_STANDARD)
    assert (v.x, v.y, v.z) == (jv.x, jv.y, jv.z)
    assert BBArrangement.ISO[0].to_human() == jwl.BBArrangement.ISO[0].to_human()


@pytest.fixture(scope="module")
def offset_in_session(tmp_path_factory):
    return _generate(str(tmp_path_factory.mktemp("wl_in") / "wl"), AS500Image, image_axes=AXES_4,
                     offset_mm_left=0.5, offset_mm_up=0.3, offset_mm_in=-0.4)


def test_3d_iso_sizes_match_jax_to_the_bit(jwl, offset_in_session):
    """The Nelder-Mead isocentre fits of a session with an 'in' offset,
    where a last-bit gap once moved the end point by 0.011 mm."""
    port = _port(offset_in_session)
    ref = jwl.WinstonLutz(offset_in_session)
    ref.analyze()
    got, want = port.results_data(as_dict=True), ref.results_data(as_dict=True)
    assert_same(got, want)
    for key in ("gantry_3d_iso_diameter_mm", "gantry_coll_3d_iso_diameter_mm"):
        assert got[key] == want[key], key
    assert port.results() == ref.results()


def _random_rays(rng):
    """Four rays at gantry 0/90/180/270 +- 1 deg through a centre uniform
    within +-1 mm, with 5 um of noise, as ``straight_ray`` draws them."""
    c = rng.uniform(-1, 1, 3)
    p1, p2 = [], []
    for g0 in (0, 90, 180, 270):
        g = np.deg2rad(g0 + rng.uniform(-1, 1))
        vx = c[0] * np.cos(g) - c[2] * np.sin(g) + rng.normal(0, 0.005)
        vy = c[1] + rng.normal(0, 0.005)
        p1.append([vx * np.cos(g) + 20 * np.sin(g), vy, -vx * np.sin(g) + 20 * np.cos(g)])
        p2.append([vx * np.cos(g) - 20 * np.sin(g), vy, -vx * np.sin(g) - 20 * np.cos(g)])
    p1, p2 = np.array(p1, np.float32), np.array(p2, np.float32)
    d = p2 - p1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p1, d


def test_minimize_axis_fit_is_jax_bit_for_bit():
    """``_minimize_axis``'s objective and Nelder-Mead (xatol 1e-5, fatol
    1e-6, 600 iterations, from the origin) against JAX's, called as JAX's
    ``_minimize_axis`` calls it (eagerly, the rays closed over), on 24
    seeded ray sets."""
    import jax.numpy as jnp

    from pylinac_tpu.ops.optimize import nelder_mead as jnm
    from pylinac_tpu_torch.ops.optimize import nelder_mead

    rng = np.random.default_rng(11)
    for i in range(24):
        p1, d = _random_rays(rng)
        p1j, dj = jnp.asarray(p1), jnp.asarray(d)

        def objective(p):
            w = p[None, :] - p1j
            return jnp.max(jnp.linalg.norm(jnp.cross(dj, -w), axis=1))

        jx, jf = jnm(objective, jnp.zeros(3, jnp.float32), xatol=1e-5, fatol=1e-6, max_iter=600)
        p1t, dt = torch.from_numpy(p1), torch.from_numpy(d)
        x, fx = nelder_mead(twl._max_ray_distance(p1t, dt), torch.zeros(3), xatol=1e-5,
                            fatol=1e-6, max_iter=600)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx), err_msg=str(i))
        assert fx.numpy() == np.asarray(jf), i


@pytest.mark.cuda
def test_card_matches_cpu(sessions):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = _port(sessions["AS500"]).results_data(as_dict=True)
    for mode, counter in (("", None), ("xla", flood.flood_from_border_batch),
                          ("packed", flood.filled_centroid_batch)):
        before = counter.launches if counter else 0
        with twl.flood_selector(mode):
            wl = WinstonLutz(sessions["AS500"])
            wl.analyze(device="cuda")
        assert_same(wl.results_data(as_dict=True), cpu)
        if counter:
            assert counter.launches > before
