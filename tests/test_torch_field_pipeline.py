"""The port's field-analysis pipeline against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``pylinac_tpu.ops.field_pipeline``
(jitted, ``vmap``-ed over profiles, as the JAX batch runs it) and through
``pylinac_tpu_torch.ops.field_pipeline``; ``FAParams`` for both come from
one numpy vector. Tolerances:

- the resampled profiles and the interpolated values: within 2e-4 (values
  up to about 1100, so two float32 ulps); ``x0`` and ``dx`` equal. The port
  rounds ``x0 + k dx`` and the interpolations once, as XLA's fused
  multiply-adds do;
- the thresholded derivative peaks: equal indices, more than 32 maxima
  above the threshold included;
- the masked fits: the line's slope within 1e-5 relative, the parabola's
  coefficients within 1e-3 relative (the port adds in float64 and solves
  in float64, JAX in float32);
- Levenberg-Marquardt and the Hill fit: the centre c within 1e-3 px, the
  other parameters within 1e-3 relative, the inflection within 1e-3 px;
- every ``analyze_field_profile`` scalar: mm within 0.01, percentages
  (flatness, symmetry, slopes, gradients) within 0.1, pixel indices within
  1e-3 px (the repo's parity bar, BASELINE.json), with the sign of every
  symmetry equal; the "top" is well conditioned on these profiles, whose
  horns and slopes are not mirror-symmetric;
- the full-frame ``field_analysis_batch`` on (4, 384, 512) frames: the
  same bars (the port adds the projections in float64, JAX in float32),
  the strip edges equal and the central-ROI statistics within 1e-5
  relative. The frames carry an FFF dome: on a flat sigmoid field the
  parabola of the "top" is nearly flat, and its vertex moved 7e-3 px
  between the two packages on one such frame.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch.ops import field_pipeline as tfp
from pylinac_tpu_torch.ops import optimize as topt

B, N, SAMPLES = 8, 240, 600
PARAMS = np.array([2.0, 0.8, 0.2, 20.0, 80.0, 0.5, 0.5, 0.0, 0.0], np.float32)
EDGES = ("FWHM", "Inflection Derivative", "Inflection Hill")
NORMALIZATIONS = ("Beam center", "Max", "Geometric center", None)
PROTOCOLS = {"VARIAN": ("difference", "point difference"), "ELEKTA": ("ratio", "pdq"),
             "SIEMENS": ("difference", "area")}
MM, PCT, PX = 0.01, 0.1, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    import jax
    import jax.numpy as jnp

    from pylinac_tpu.ops import field_pipeline as jfp
    from pylinac_tpu.ops import optimize as jopt
    from pylinac_tpu.ops.filters import gaussian_filter1d

    params = jfp.FAParams(*(jnp.float32(v) for v in PARAMS))
    return SimpleNamespace(jax=jax, jnp=jnp, jfp=jfp, jopt=jopt, params=params,
                           gaussian_filter1d=gaussian_filter1d)


def _sig(x):
    return 1.0 / (1.0 + np.exp(np.clip(-x, -60, 60)))


def _profiles(seed: int = 0, n: int = N) -> np.ndarray:
    """B field profiles: flat with horns, FFF peaks and sloped fields, each
    with its own edges and seeded noise, on a 50-count floor."""
    rng = np.random.default_rng(seed)
    x = np.arange(n, dtype=np.float64)
    out = []
    for i in range(B):
        lo, hi = 0.25 * n + rng.normal(0, 2), 0.75 * n + rng.normal(0, 2)
        field = _sig((x - lo) / rng.uniform(1.5, 3)) - _sig((x - hi) / rng.uniform(1.5, 3))
        c = (lo + hi) / 2
        if i % 3 == 0:      # horns
            shape = 1 - 0.04 * np.exp(-((x - c) / (0.15 * n)) ** 2)
        elif i % 3 == 1:    # FFF
            shape = 0.6 + 0.4 * np.exp(-((x - c) / (0.3 * n)) ** 2)
        else:               # slope
            shape = 1 + rng.uniform(-0.2, 0.2) * (x - c) / n
        out.append(1000 * field * shape + 50 + rng.normal(0, 1.5, n))
    return np.stack(out).astype(np.float32)


def _tparams():
    return tfp.FAParams.from_vector(PARAMS, "cpu")


def test_fa_params_from_vector():
    p = _tparams()
    assert [float(v) for v in p] == [float(v) for v in PARAMS]
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in p)
    with pytest.raises(ValueError, match="9 values"):
        tfp.FAParams.from_vector(PARAMS[:5], "cpu")


@pytest.mark.parametrize("samples", [600, 601, 2400])
def test_resample_linear(jref, samples):
    v = _profiles(1)
    want = jref.jax.jit(jref.jax.vmap(lambda r: jref.jfp._resample_linear(r, samples)))(
        jref.jnp.asarray(v))
    got, x0, dx = tfp._resample_linear(torch.from_numpy(v), samples)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)
    assert x0 == float(want[1][0]) and dx == float(want[2][0])


def test_y_at_frac(jref):
    rng = np.random.default_rng(2)
    v = _profiles(2)
    idx = rng.uniform(-3, N + 3, (B, 50)).astype(np.float32)   # the ends extrapolate
    want = jref.jax.jit(jref.jax.vmap(jref.jfp._y_at_frac))(jref.jnp.asarray(v),
                                                              jref.jnp.asarray(idx))
    got = tfp._y_at_frac(torch.from_numpy(v), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)
    one = tfp._y_at_frac(torch.from_numpy(v), torch.from_numpy(idx[:, 0]))
    np.testing.assert_array_equal(one.numpy(), got.numpy()[:, 0])


def _noisy_signals():
    """Derivative-like rows: the smoothed derivative of real profiles, and
    rows whose noise puts far more than 32 maxima above the threshold."""
    v = _profiles(3)
    d1 = np.gradient(v, axis=1).astype(np.float32)
    rng = np.random.default_rng(4)
    noisy = (0.9 + 0.1 * rng.random((B, 2000))).astype(np.float32)
    return d1, noisy


PEAK_DISTANCES = (1.0, 5.0, 30.0)


@pytest.fixture(scope="module")
def jax_peaks(jref):
    """(first, distance) -> JAX's peaks of the three signals; one jitted
    call a signal shape covers every case."""
    def every_case(s):
        return {(first, distance): jref.jfp._first_thresholded_peak(s, distance, first=first)
                for first in (True, False) for distance in PEAK_DISTANCES}

    fn = jref.jax.jit(jref.jax.vmap(every_case))
    d1, noisy = _noisy_signals()
    out = {}
    for sig in (d1, -d1, noisy):
        for key, peaks in fn(jref.jnp.asarray(sig)).items():
            out.setdefault(key, []).append(np.asarray(peaks))
    return out


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("distance", PEAK_DISTANCES)
def test_first_thresholded_peak(jax_peaks, first, distance):
    d1, noisy = _noisy_signals()
    t = tfp._local_maxima(torch.from_numpy(noisy))
    lo, hi = noisy.min(1, keepdims=True), noisy.max(1, keepdims=True)
    above = (t.numpy() & (noisy >= lo + np.float32(0.8) * (hi - lo))).sum(1)
    assert above.min() > tfp.K_DERIV     # the slots overflow: the excess is dropped
    for sig, want in zip((d1, -d1, noisy), jax_peaks[first, distance]):
        got = tfp._first_thresholded_peak(torch.from_numpy(sig), distance, first=first)
        np.testing.assert_array_equal(got.numpy(), want)


def _windows(seed: int):
    rng = np.random.default_rng(seed)
    x = np.broadcast_to(np.arange(SAMPLES, dtype=np.float32) * 0.4 - 0.3, (B, SAMPLES))
    y = (1 + 0.02 * np.sin(x / 30) + rng.normal(0, 0.003, (B, SAMPLES))).astype(np.float32)
    lo = rng.integers(0, SAMPLES // 2, B)[:, None]
    hi = lo + rng.integers(3, SAMPLES // 2, B)[:, None]
    k = np.arange(SAMPLES)
    return np.ascontiguousarray(x), y, (k >= lo) & (k <= hi)


def test_masked_linear_fit(jref):
    x, y, m = _windows(5)
    wa, wb = jref.jax.jit(jref.jax.vmap(jref.jfp._masked_linear_fit))(x, y, m)
    ta, tb = tfp._masked_linear_fit(*(torch.from_numpy(a) for a in (x, y, m)))
    np.testing.assert_allclose(ta.numpy(), np.asarray(wa), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(tb.numpy(), np.asarray(wb), rtol=1e-5)


def test_masked_quadratic_fit(jref):
    x, y, m = _windows(6)
    want = jref.jax.jit(jref.jax.vmap(jref.jfp._masked_quadratic_fit))(x, y, m)
    got = tfp._masked_quadratic_fit(*(torch.from_numpy(a) for a in (x, y, m)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-9)


def _hill_data(seed: int):
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(B):
        x = np.arange(20, 60, dtype=np.float32) + np.float32(rng.uniform(0, 3))
        c, d = 40 + rng.normal(0, 2), rng.choice([-1, 1]) * rng.uniform(5, 20)
        ys.append((0.1 + 1 / (1 + (c / x) ** d) + rng.normal(0, 0.01, x.shape)).astype(np.float32))
        xs.append(x)
    return np.stack(xs), np.stack(ys)


def _check_hill(got: np.ndarray, want: np.ndarray):
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_hill_fit(jref):
    x, y = _hill_data(7)
    want = np.asarray(jref.jax.vmap(jref.jopt.hill_fit)(x, y))
    got = topt.hill_fit(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    _check_hill(got, want)
    np.testing.assert_allclose(topt.hill_inflection(torch.from_numpy(got)).numpy(),
                               np.asarray(jref.jax.vmap(jref.jopt.hill_inflection)(want)),
                               rtol=0, atol=1e-3)
    xq = np.float32(40.0)
    np.testing.assert_allclose(
        topt.hill_gradient(torch.from_numpy(got), torch.full((B,), 40.0)).numpy(),
        np.asarray(jref.jax.vmap(lambda p: jref.jopt.hill_gradient(p, xq))(got)), rtol=1e-5)
    y_mid = (got[:, 0] + got[:, 1]) / 2
    np.testing.assert_allclose(
        topt.hill_x_at_y(torch.from_numpy(got), torch.from_numpy(y_mid)).numpy(),
        np.asarray(jref.jax.vmap(jref.jopt.hill_x_at_y)(got, y_mid)), rtol=1e-5)


def test_levenberg_marquardt(jref):
    """A Gaussian plus offset, P problems in one solve, against the JAX
    solver ``vmap``-ed over them (``ops/optimize.py:110-143``)."""
    rng = np.random.default_rng(8)
    x = np.broadcast_to(np.linspace(-5, 5, 60, dtype=np.float32), (B, 60)).copy()
    truth = np.stack([rng.uniform(1, 3, B), rng.uniform(-1, 1, B), rng.uniform(0.5, 1.5, B),
                      rng.uniform(-0.2, 0.2, B)], 1).astype(np.float32)
    y = (truth[:, :1] * np.exp(-0.5 * ((x - truth[:, 1:2]) / truth[:, 2:3]) ** 2)
         + truth[:, 3:] + rng.normal(0, 0.01, x.shape)).astype(np.float32)
    p0 = np.stack([np.ptp(y, 1), np.zeros(B), np.ones(B), y.min(1)], 1).astype(np.float32)

    def model(p, xx):
        a, mu, sig, off = (p[:, i:i + 1] for i in range(4))
        return a * (-0.5 * ((xx - mu) / sig) ** 2).exp() + off

    got = topt.levenberg_marquardt(lambda p, xx, yy: model(p, xx) - yy, torch.from_numpy(p0),
                                   torch.from_numpy(x), torch.from_numpy(y), n_iter=40).numpy()
    jnp = jref.jnp

    def one(p, xx, yy):
        return jref.jopt.levenberg_marquardt(
            lambda q: q[0] * jnp.exp(-0.5 * ((xx - q[1]) / q[2]) ** 2) + q[3] - yy, p, n_iter=40)

    want = np.asarray(jref.jax.vmap(one)(p0, x, y))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, truth, atol=0.05)


def test_forward_jacobian_is_jacfwd():
    """The solver's stacked dual-number Jacobian equals
    ``torch.func.jacfwd`` of each problem, bit for bit."""
    x, y = _hill_data(12)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    p = topt.hill_fit(x, y, n_iter=5)

    def one(q, xx, yy):
        return topt.hill_func(xx, q[0], q[1], q[2], q[3]) - yy

    want = torch.func.vmap(torch.func.jacfwd(one))(p, x, y)
    r, got = topt._jacobian(topt._hill_residual, p, topt._stack_problems((x, y), 4),
                            topt._unit_tangents(B, 4, "cpu"))
    assert torch.equal(got, want)
    assert torch.equal(r, topt._hill_residual(p, x, y))


def _tolerance(key: str) -> float:
    if key in ("flatness", "symmetry") or "pct" in key:
        return PCT
    if key.endswith("_idx"):
        return PX
    return MM


@pytest.fixture(scope="module")
def jax_profile_outputs(jref):
    """edge -> JAX's outputs under every normalisation and protocol, from
    one jitted call (one compile an edge), each edge computed once."""
    done = {}

    def get(edge: str):
        if edge not in done:
            def every_case(v):
                return {str(normalization): {name: jref.jfp.analyze_field_profile(
                    v, jref.params, samples=SAMPLES, edge=edge, centering="Beam center",
                    normalization=normalization, flatness=f, symmetry=s)
                    for name, (f, s) in PROTOCOLS.items()} for normalization in NORMALIZATIONS}

            out = jref.jax.jit(jref.jax.vmap(every_case))(jref.jnp.asarray(_profiles(9)))
            done[edge] = jref.jax.tree.map(np.asarray, out)
        return done[edge]

    return get


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
@pytest.mark.parametrize("normalization", NORMALIZATIONS)
@pytest.mark.parametrize("edge", EDGES)
def test_analyze_field_profile(jax_profile_outputs, edge, normalization, protocol):
    want = jax_profile_outputs(edge)[str(normalization)][protocol]
    flatness, symmetry = PROTOCOLS[protocol]
    got = tfp.analyze_field_profile(
        torch.from_numpy(_profiles(9)), _tparams(), samples=SAMPLES, edge=edge,
        centering="Beam center", normalization=normalization, flatness=flatness,
        symmetry=symmetry)
    assert sorted(got) == sorted(want)  # JAX returns its dicts with sorted keys
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == (B,) and g.dtype == np.float32
        diff = np.abs(g.astype(np.float64) - w).max()
        assert diff <= _tolerance(key), f"{key}: max |diff| {diff}"
    assert np.array_equal(np.sign(got["symmetry"].numpy()), np.sign(want["symmetry"]))


def test_analyze_field_profile_geometric_centering(jref):
    """The field window about the CAX."""
    import jax

    kw = dict(samples=SAMPLES, edge="Inflection Derivative", centering="Geometric center",
              normalization="Beam center", flatness="difference", symmetry="point difference")
    v = _profiles(10)
    want = jax.jit(jax.vmap(lambda r: jref.jfp.analyze_field_profile(r, jref.params, **kw)))(v)
    got = tfp.analyze_field_profile(torch.from_numpy(v), _tparams(), **kw)
    for key, w in want.items():
        diff = np.abs(got[key].numpy().astype(np.float64) - np.asarray(w)).max()
        assert diff <= _tolerance(key), f"{key}: max |diff| {diff}"


def _frames(n: int = 4, h: int = 384, w: int = 512, beam: str = "dome",
            seed: int = 11) -> np.ndarray:
    """AS500-sized open fields with seeded centres, sizes and noise (the
    shape of the repository's graft entry example). ``beam`` "dome" gives
    each an FFF dome, so that its "top" is well defined; "horns" gives a
    flattened field's 3 % central dip of sigma 32 mm, as
    ``FilteredFieldLayer`` draws it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    out = []
    for i in range(n):
        cy, cx = h / 2 + rng.normal(0, 2), w / 2 + rng.normal(0, 2)
        half = 60 + 5 * i
        v = (_sig((xx - (cx - half)) / 2) - _sig((xx - (cx + half)) / 2))
        v *= (_sig((yy - (cy - half)) / 2) - _sig((yy - (cy + half)) / 2))
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2
        if beam == "dome":
            v *= 0.7 + 0.3 * np.exp(-r2 / (2 * (0.5 * half) ** 2))
        else:
            v *= 1 - 0.03 * np.exp(-r2 / (2 * (32 * PARAMS[0]) ** 2))
        out.append(1000 * v + rng.normal(0, 3, (h, w)))
    return np.stack(out).astype(np.float32)


def _full_frame(jref, images, edge, centering="Beam center", strips=(0.5, 0.5, 0.0, 0.0)):
    """Both packages' ``field_analysis_batch`` of ``images``; the strip
    edges equal and the central-ROI statistics within 1e-5 relative."""
    vec = PARAMS.copy()
    vec[5:] = strips
    static = dict(samples_v=1920, samples_h=2560, edge=edge, centering=centering,
                  normalization="Beam center", flatness="difference", symmetry="point difference")
    jp = jref.jfp.FAParams(*(jref.jnp.float32(v) for v in vec))
    want = jref.jax.tree.map(np.asarray, jref.jfp.field_analysis_batch(
        jref.jnp.asarray(images), jp, **static))
    got = tfp.field_analysis_batch(images, tfp.FAParams.from_vector(vec, "cpu"),
                                   device="cpu", **static)
    np.testing.assert_array_equal(got["strip_edges"].numpy(), want["strip_edges"])
    for key, w in want["central_roi"].items():
        np.testing.assert_allclose(got["central_roi"][key].numpy(), w, rtol=1e-5, atol=1e-4)
    return got, want


def _check_side(got, want, side, frames=slice(None), top=None):
    """Every field of one side's profiles ``frames`` within its bar; the
    "top" fields within ``top`` = (px, mm) where given."""
    assert sorted(got[side]) == sorted(want[side])
    for key, w in want[side].items():
        bar = _tolerance(key)
        if top is not None and key.startswith("top"):
            bar = top[0] if key.endswith("_idx") else top[1]
        diff = np.abs(got[side][key].numpy()[frames].astype(np.float64) - w[frames]).max()
        assert diff <= bar, f"{side} {key}: max |diff| {diff}"


FULL_CASES = [(edge, "Beam center", (0.5, 0.5, 0.0, 0.0)) for edge in EDGES] + [
    ("Inflection Derivative", "Manual", (0.45, 0.55, 0.02, 0.03))]


@pytest.mark.parametrize("edge,centering,strips", FULL_CASES)
def test_field_analysis_batch_full_frame(jref, edge, centering, strips):
    got, want = _full_frame(jref, _frames(), edge, centering, strips)
    for side in ("vert", "horiz"):
        _check_side(got, want, side)


# The "top" of a flattened field: its central dip makes the parabola over
# the in-field window nearly flat (or open upward, when the top is a window
# end), so its vertex moves far more than the profile does. The projections
# that place the strips add in float32 in JAX and in float64 in the port,
# and the normal equations solve in float32 and float64; the vertex moved
# 1.13e-3 px (FWHM) on these frames, and up to 2.87e-2 px (0.0144 mm) over
# the seeds 11-30 of this generator (edges and strips equal). Bars with
# margin, logged in ROADMAP section 3; every other field holds the parity
# bars.
HORNS_TOP = (0.04, 0.02)    # px, mm


@pytest.mark.parametrize("edge", EDGES)
def test_field_analysis_batch_full_frame_horns(jref, edge):
    got, want = _full_frame(jref, _frames(beam="horns"), edge)
    for side in ("vert", "horiz"):
        _check_side(got, want, side, top=HORNS_TOP)


def test_field_analysis_batch_full_frame_derivative_near_tie(jref):
    """The gap of a near-tie, measured on the seed-15 horns frames. The
    smoothed derivative of frame 0's horizontal strip peaks at two
    neighbouring samples 8 float32 ulps apart (21.392029 and 21.392014 in
    JAX). XLA's fused Gaussian and the port's tap-by-tap one (``ops/
    filters.py``) round them in opposite orders, so the left edge moves one
    grid step: 0.1 px on the beam centre and 0.1 mm on the field size, with
    the penumbra and every field measured from the edges moving with it.
    Every other profile holds the parity bars."""
    images = _frames(beam="horns", seed=15)
    got, want = _full_frame(jref, images, "Inflection Derivative")
    _check_side(got, want, "vert", top=HORNS_TOP)
    _check_side(got, want, "horiz", frames=slice(1, None), top=HORNS_TOP)
    step_px = 512 / 2560    # dx of the horizontal grid
    for key, bar in (("beam_center_idx", step_px / 2), ("field_size_mm", step_px / PARAMS[0])):
        diff = abs(float(got["horiz"][key][0]) - float(want["horiz"][key][0]))
        assert diff <= bar + 1e-4, f"horiz {key}: |diff| {diff} over one grid step"
    # the tie itself, in JAX's derivative of that strip
    row = images[0, int(want["strip_edges"][0, 2])]
    d1 = jref.jnp.gradient(jref.gaussian_filter1d(
        jref.jfp._resample_linear(jref.jnp.asarray(row), 2560)[0], sigma=0.003 * 2560))
    d1 = np.asarray(d1)
    k = int(np.argmax(d1[:1280]))
    assert abs(d1[k] - max(d1[k - 1], d1[k + 1])) < 2e-5 * abs(d1[k])


def test_field_analysis_batch_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfp.field_analysis_batch(_frames(1, 32, 32), _tparams(), samples_v=80, samples_h=80,
                                 edge="FWHM", centering="Beam center",
                                 normalization="Beam center", flatness="difference",
                                 symmetry="point difference")
