"""The port's starshot analyses against the JAX package's, on the CPU.

Inputs: stars from the port's copy of the test image (``make_starshot``),
at 500 x 520 px with the centre at (250, 260) so that the JAX runs stay
short, written once and read by both packages: 5 and 4 spokes, a wobbly
star, one whose extra half spoke fails the first six combos of the retry
ladder, and a film-like one that trips the inversion check.

Tolerances:

- ``percentile_f32``, ``linspace_f32`` and ``starshot_batch``'s integer,
  boolean and start-point outputs: exact;
- ``nelder_mead_batch``: bit-equal, problem by problem, to the port's
  ``nelder_mead`` and to ``jax.vmap(nelder_mead)`` (the port fuses the
  multiply-adds XLA fuses on the CPU; without that they were 7.6e-5 to
  2.4e-4 px apart);
- the spoke ends, wobble centre and radius of ``starshot_batch``: within
  1e-3 px (measured: the ends differ in the last bit, 1.5e-5 px, on 2-3 of
  20 noisy stars of seeds 11-30 and on none of these; the centres equal,
  the radii within 3.5e-6 px);
- ``results_data()``: the parity bar, 0.01 mm for the diameter and radius,
  1e-3 px for the centre, 1e-3 degrees for the angles; ``passed``, the
  number of lines, the keys and their order exact.

``StarshotBatch`` runs on the card by default (``device=None``); without a
card it raises.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.imggen.utils import make_starshot
from pylinac_tpu_torch.ops import star_pipeline as tsp
from pylinac_tpu_torch.ops.optimize import nelder_mead, nelder_mead_batch
from pylinac_tpu_torch.ops.stats import linspace_f32, percentile_f32
from pylinac_tpu_torch.starshot import Starshot, StarshotBatch, analyze_star_batch

MM, PX, DEG = 0.01, 1e-3, 1e-3
SMALL = dict(center=(250, 260), size=(500, 520))
STARS = {
    "five": dict(n_spokes=5, angles_offset=10.0),
    "four": dict(n_spokes=4, angles_offset=20.0),
    "wobbly": dict(n_spokes=5, wobble_shift_px=3.0),
    "ladder": dict(n_spokes=5, angles_offset=12.0, half_spoke=0.5),
    "film": dict(n_spokes=5, angles_offset=14.0, invert=True, noise=20.0),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jss():
    import pylinac_tpu.starshot as jss

    return jss


@pytest.fixture(scope="module")
def star_paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_star")
    return [make_starshot(tmp, name=f"{name}.dcm", **SMALL, **spec)
            for name, spec in STARS.items()]


@pytest.fixture(scope="module", params=[True, False], ids=["fwhm", "peaks"])
def batches(request, jss, star_paths):
    """(port, JAX) ``StarshotBatch`` of every star, analysed once a
    ``fwhm`` setting."""
    j = jss.StarshotBatch(star_paths)
    j.analyze(fwhm=request.param)
    t = StarshotBatch(star_paths)
    t.analyze(fwhm=request.param, device="cpu")
    return t, j, request.param


def _assert_results_match(t, j):
    assert [f.name for f in dataclasses.fields(t)] == list(type(j).model_fields)
    assert list(t.model_dump()) == list(j.model_dump())
    assert t.tolerance_mm == j.tolerance_mm
    assert t.passed == j.passed
    assert t.circle_diameter_mm == pytest.approx(j.circle_diameter_mm, abs=MM)
    assert t.circle_radius_mm == pytest.approx(j.circle_radius_mm, abs=MM)
    np.testing.assert_allclose(t.circle_center_x_y, j.circle_center_x_y, rtol=0, atol=PX)
    assert len(t.angles) == len(j.angles)
    np.testing.assert_allclose(t.angles, j.angles, rtol=0, atol=DEG)


# --- the float32 building blocks ---------------------------------------------
def test_percentile_f32_is_jax_bit_for_bit(tmp_path):
    """At the path's sizes: the bench's 1000 x 1040 star, its central
    third, q = (4, 50, 96) and 90, and a noisy film-like star."""
    import jax.numpy as jnp

    from pylinac_tpu_torch.core import image as timage

    for i, spec in enumerate([{}, dict(noise=30.0, invert=True, angles_offset=17.0)]):
        arr = timage.load(make_starshot(tmp_path, name=f"{i}.dcm", **spec)).array
        img = arr.astype(np.float32)
        h, w = img.shape
        central = img[h // 3:2 * (h // 3), w // 3:2 * (w // 3)]
        for values, qs in ((img, [4.0, 50.0, 96.0]), (central, [90.0])):
            want = np.asarray(jnp.percentile(jnp.asarray(values), jnp.asarray(qs)))
            got = percentile_f32(torch.from_numpy(values)[None], qs)[0].numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num", [2, 3, 5, 20, 33, 34, 35, 50, 100])
def test_linspace_f32_is_jax_bit_for_bit(num):
    """``jnp.linspace`` of traced float32 ends, one pair a call, as the
    single-image call compiles it. (Under ``vmap`` in the batched
    pipeline XLA fuses it otherwise: 58-75 of 320 ring radii differ in the
    last bit there, ROADMAP section 3.)"""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(num)
    starts = rng.uniform(-600, 600, 64).astype(np.float32)
    stops = rng.uniform(-600, 600, 64).astype(np.float32)
    lin = jax.jit(lambda a, b: jnp.linspace(a, b, num))
    want = np.stack([np.asarray(lin(a, b)) for a, b in zip(starts, stops)])
    got = linspace_f32(torch.from_numpy(starts), torch.from_numpy(stops), num).numpy()
    np.testing.assert_array_equal(got, want)


def _minimax_problems(n_problems=6, n_lines=5, seed=0):
    """Lines near a point, with wobbles from none to large: their minimax
    fits stop at different iterations."""
    rng = np.random.default_rng(seed)
    p1 = np.empty((n_problems, n_lines, 2), np.float32)
    d = np.empty_like(p1)
    x0 = np.empty((n_problems, 2), np.float32)
    for i in range(n_problems):
        c = rng.uniform(200, 300, 2)
        ang = np.sort(rng.uniform(0, np.pi, n_lines))
        off = rng.normal(0, 0.5 * i, n_lines)
        u = np.stack([np.cos(ang), np.sin(ang)], 1)
        nrm = np.stack([-u[:, 1], u[:, 0]], 1)
        p1[i] = c - 180 * u + off[:, None] * nrm
        d[i] = u
        x0[i] = np.round(c + rng.normal(0, 3, 2))
    return torch.from_numpy(p1), torch.from_numpy(d), torch.from_numpy(x0)


def _cross(w, d):
    return tsp._cross(w[..., 0], w[..., 1], d[..., 0], d[..., 1])


def test_nelder_mead_batch_is_nelder_mead_problem_by_problem():
    p1, d, x0 = _minimax_problems()

    def batch_f(pts):                                     # (P, m, 2) -> (P, m)
        return _cross(pts[:, :, None, :] - p1[:, None], d[:, None]).amax(dim=2)

    xb, fb = nelder_mead_batch(batch_f, x0, xatol=1e-4, fatol=1e-3, max_iter=400)
    iters = []
    for i in range(len(x0)):
        calls = []

        def f(p, i=i):
            calls.append(1)
            return _cross(p[None, :] - p1[i], d[i]).max()

        xs, fs = nelder_mead(f, x0[i], xatol=1e-4, fatol=1e-3, max_iter=400)
        assert torch.equal(xs, xb[i]) and torch.equal(fs, fb[i]), i
        iters.append(len(calls))
    assert len(set(iters)) > 3, iters               # the problems stop apart
    # every problem run alone in a batch of one, which stops at its own
    # iteration, gives the same bits
    for i in range(len(x0)):
        x1, f1 = nelder_mead_batch(
            lambda pts, i=i: _cross(pts[:, :, None, :] - p1[i:i + 1, None], d[i:i + 1, None]
                                    ).amax(dim=2), x0[i:i + 1], xatol=1e-4, fatol=1e-3,
            max_iter=400)
        assert torch.equal(x1[0], xb[i]) and torch.equal(f1[0], fb[i])


def test_nelder_mead_batch_against_jax_vmap():
    import jax
    import jax.numpy as jnp

    from pylinac_tpu.ops.optimize import nelder_mead as jnm

    p1, d, x0 = _minimax_problems(seed=1)

    def batch_f(pts):
        return _cross(pts[:, :, None, :] - p1[:, None], d[:, None]).amax(dim=2)

    xb, fb = nelder_mead_batch(batch_f, x0, xatol=1e-4, fatol=1e-3, max_iter=400)

    def one(a, dd, x):
        def f(p):
            w = p[None, :] - a
            return jnp.max(jnp.abs(w[:, 0] * dd[:, 1] - w[:, 1] * dd[:, 0]))
        return jnm(f, x, fatol=0.001, xatol=1e-4, max_iter=400)

    jx, jf = jax.jit(jax.vmap(one))(p1.numpy(), d.numpy(), x0.numpy())
    np.testing.assert_array_equal(xb.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(jf))


# --- the batched pipeline ----------------------------------------------------
def test_starshot_batch_matches_jax_key_by_key(batches):
    t, j, _ = batches
    assert sorted(t._out) == sorted(j._out)
    for key, want in j._out.items():
        got = t._out[key]
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if want.dtype.kind == "f" and key != "start_point":
            np.testing.assert_allclose(got, want, rtol=0, atol=PX, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    tried = dict(zip(STARS, t._out["combos_tried"].tolist()))
    assert tried["ladder"] == 7 and tried["five"] == 1
    assert t._out["n_lines"].tolist() == [5, 4, 5, 5, 5]


def test_batch_results_data_match_jax(batches):
    t, j, _ = batches
    for tr, jr in zip(t.results_data(), j.results_data()):
        _assert_results_match(tr, jr)
    assert [r.passed for r in t.results_data()] == [True, True, False, True, True]
    assert list(t.results_data(as_dict=True)[0]) == list(j.results_data()[0].model_dump())
    assert json.loads(t.results_data(as_json=True)[0])["angles"] == pytest.approx(
        j.results_data()[0].angles, abs=DEG)


def test_batch_finds_the_drawn_centre(batches):
    t, _, fwhm = batches
    for name, r in zip(STARS, t.results_data()):
        if name != "wobbly":
            assert r.circle_center_x_y == pytest.approx((250, 260), abs=0.1), name
            # the spoke ends sit on whole samples without the FWHM centres
            assert r.circle_diameter_mm < (0.05 if fwhm else 0.1), name
    assert 0.2 < t.results_data()[2].circle_diameter_mm < 2.0


def test_chunk_changes_no_result(batches, star_paths):
    t, _, fwhm = batches
    c = StarshotBatch(star_paths)
    c.analyze(fwhm=fwhm, chunk=2, device="cpu")
    for key, want in t._out.items():
        np.testing.assert_array_equal(c._out[key], want, err_msg=key)


def test_not_recursive_raises_as_jax_does(jss, star_paths):
    ladder = [star_paths[list(STARS).index("ladder")]]
    with pytest.raises(RuntimeError, match="reasonable wobble"):
        jss.StarshotBatch(ladder).analyze(recursive=False)
    with pytest.raises(RuntimeError, match="reasonable wobble"):
        StarshotBatch(ladder).analyze(recursive=False, device="cpu")


def test_analyze_without_device_needs_cuda(star_paths):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        StarshotBatch(star_paths[:1]).analyze()


def test_shape_mismatch(tmp_path):
    a = make_starshot(tmp_path, name="a.dcm", **SMALL)
    b = make_starshot(tmp_path, name="b.dcm", center=(250, 260), size=(480, 520))
    with pytest.raises(ValueError, match="share one shape"):
        StarshotBatch([a, b])


def test_analyze_star_batch(star_paths):
    results = analyze_star_batch(star_paths[:2], device="cpu")
    assert [len(r.angles) for r in results] == [5, 4]


# --- the single image --------------------------------------------------------
@pytest.mark.parametrize("name", list(STARS))
def test_single_image_matches_jax(jss, star_paths, name):
    path = star_paths[list(STARS).index(name)]
    j = jss.Starshot(path)
    j.analyze()
    t = Starshot(path)
    t.analyze()
    _assert_results_match(t.results_data(), j.results_data())
    assert len(t.lines) == len(j.lines)
    assert t.results() == j.results()


def test_single_image_from_multiple_and_zip(jss, star_paths, tmp_path):
    import zipfile

    pair = star_paths[:1] * 2
    t = Starshot.from_multiple_images(pair)
    t.analyze()
    j = jss.Starshot.from_multiple_images(pair)
    j.analyze()
    _assert_results_match(t.results_data(), j.results_data())
    zpath = tmp_path / "star.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.write(star_paths[0], "star.dcm")
    z = Starshot.from_zip(str(zpath))
    z.analyze()
    one = Starshot(star_paths[0])
    one.analyze()
    assert z.results_data().circle_center_x_y == one.results_data().circle_center_x_y
    assert z.results_data().angles == one.results_data().angles
