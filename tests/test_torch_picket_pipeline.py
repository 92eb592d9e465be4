"""The port's batched picket fence pipeline against the JAX package's.

Both pipelines get the same uint16 frames and the same leaf config and
parameters (the JAX ones, carried over with ``leaf_config_from_numpy`` and
``params_from_numpy``), and their output dicts are compared key by key.

Tolerances: integer and mask outputs are exact. Float outputs in pixels
are held to 1e-3 px and those in mm to 1e-3 px / dpmm: the pipelines sum
rows, windows and line fits in different orders, which moves float32
results by far less than that. The de-spike loop is a selection and a
comparison of exact percentiles, so its pass counts and the conditioned
frames are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylinac_tpu.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
from pylinac_tpu.imggen.simulators import AS500Image
from pylinac_tpu.imggen.utils import generate_picketfence
from pylinac_tpu.ops import filters as jfilters
from pylinac_tpu.ops import picket_pipeline as jpp
from pylinac_tpu.ops import stats as jstats
from pylinac_tpu.picketfence import PicketFenceBatch as JaxBatch
from pylinac_tpu_torch.ops import picket_pipeline as tpp

PX_TOL = 1e-3
MM_KEYS = ("errors_mm", "dist2cax_mm")
EXPECTED_PASSES = [0, 1, 3, 5]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spiked_frames(base: list[np.ndarray], seed: int) -> np.ndarray:
    """Four uint16 frames scaled like an unsaturated EPID frame (x0.5 plus a
    1000-count dark offset, sigma-2 count noise) needing 0, 1, 3 and 5
    de-spike passes: clean; isolated hot pixels; 3x3 hot blocks (a 3x3
    median peels one ring per pass); a 9x9 hot block (outlasts the cap)."""
    rng = np.random.default_rng(seed)
    frames = []
    for k in range(4):
        raw = base[k % len(base)].astype(np.float64) * 0.5 + 1000
        raw += rng.normal(0, 2, raw.shape).round()
        frame = np.clip(raw, 0, 65535)
        h, w = frame.shape
        if k == 1:
            n_hot = max(int(1e-4 * frame.size), 5)
            frame.flat[rng.choice(frame.size, n_hot, replace=False)] = 65535
        elif k == 2:
            for r, c in rng.integers(20, min(h, w) - 20, size=(4, 2)):
                frame[r:r + 3, c:c + 3] = 65535
        elif k == 3:
            frame[h // 3:h // 3 + 9, w // 3:w // 3 + 9] = 65535
        frames.append(frame.astype(np.uint16))
    return np.stack(frames)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pf_pipeline")
    paths = []
    for i, err in enumerate(([0] * 8, [0, 0, 0.4, 0, 0, 0, 0, 0])):
        path = str(tmp / f"pf{i}.dcm")
        generate_picketfence(
            simulator=AS500Image(sid=1500), field_layer=PerfectFieldLayer,
            file_out=path, final_layers=[GaussianFilterLayer(sigma_mm=1)],
            pickets=8, picket_spacing_mm=20, picket_width_mm=3,
            picket_offset_error=err)
        paths.append(path)
    jb = JaxBatch(paths)
    frames = _spiked_frames([im.array for im in jb.images], seed=5)
    dpmm = float(jb.images[0].dpmm)
    _, H, W = frames.shape
    cfg, _, h_max = jb._leaf_config(H, dpmm, 0.4)
    params = jpp.PFParams(
        height_threshold=jnp.float32(0.5), edge_threshold=jnp.float32(1.5),
        required_prominence=jnp.float32(0.2), fwxm=jnp.float32(50),
        dpmm=jnp.float32(dpmm), cax_col=jnp.float32(W / 2 - 0.5),
        analysis_ratio=jnp.float32(0.4),
        nominal_gap_px=jnp.float32(3 / 2 * dpmm), invert=np.bool_(False))
    static = dict(K_P=16, W_MAX=64, H_MAX=-(-h_max // 8) * 8, chunk=2)
    return frames, cfg, params, static, dpmm


def _jax_despike_passes(frame: np.ndarray) -> int:
    """Passes the JAX de-spike loop takes (``picket_pipeline.py:80-103``),
    driven one pass at a time through the JAX functions."""
    a = jnp.asarray(frame, jnp.float32)
    for n in range(5):
        near = jstats.percentile_exact(a, (0.5, 99.5))
        vmin, vmax = jnp.min(a), jnp.max(a)
        noisy = (vmax > near[1] * 1.25) | ((vmin < near[0] * 0.75) & (
            jnp.abs(vmin - near[0]) > 0.1 * (near[1] - near[0])))
        if not bool(noisy):
            return n
        a = jfilters._median_general(a, 3)
    return 5


@pytest.mark.parametrize("separate_leaves", [False, True])
def test_pipeline_matches_jax(setup, separate_leaves):
    frames, cfg, params, static, dpmm = setup
    want = jpp.picket_fence_batch(jnp.asarray(frames), cfg, params, preprocess=True,
                                  separate_leaves=separate_leaves, **static)
    got = tpp.picket_fence_batch(
        torch.from_numpy(frames), tpp.leaf_config_from_numpy(cfg, "cpu"),
        tpp.params_from_numpy(params, "cpu"), separate_leaves=separate_leaves,
        **static)
    assert set(want) <= set(got)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.shape == w.shape, key
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            tol = PX_TOL / dpmm if key in MM_KEYS else PX_TOL
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=key)
    assert int(got["n_pickets"].min()) == 8
    assert got["kiss_valid"].any()


def test_despike_passes_match_jax(setup):
    frames, cfg, params, static, _ = setup
    got = tpp.picket_fence_batch(
        torch.from_numpy(frames), tpp.leaf_config_from_numpy(cfg, "cpu"),
        tpp.params_from_numpy(params, "cpu"), **static)
    passes = got["despike_passes"].tolist()
    assert passes == [_jax_despike_passes(f) for f in frames]
    assert passes == EXPECTED_PASSES


@pytest.mark.parametrize("extra_filter, invert", [(0, False), (5, True)])
def test_preprocess_matches_jax(setup, extra_filter, invert):
    frames = setup[0]
    want = jax.vmap(lambda im: jpp.preprocess_pf_image(
        im, despike=True, extra_filter=extra_filter, invert=invert))(jnp.asarray(frames))
    got, passes = tpp.preprocess_pf_image(torch.from_numpy(frames),
                                          extra_filter=extra_filter, invert=invert)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert passes.tolist() == EXPECTED_PASSES
