"""The port's filter sums against XLA's on the CPU: the contracted forms of
``pylinac_tpu_torch.ops.filters`` and the Otsu running sums of
``ops.threshold`` against the jitted JAX graphs they stand for.

The CIRS 062M of the watch list (a 330 x 270 mm body, 30 mm inserts, seed
62, drawn by ``test_torch_cheese.draw_cirs062m``) is where the port with
each filter op rounded and torch's ``cumsum`` gave slice 1 of the pooled
localisation stack an Otsu threshold of 83.213486 against JAX's 84.15375.
Its pooled edges, thresholds and masks must now equal JAX's native-route
graph (``ct._stack_mask_pack``) bit for bit. So must the vmapped mask
stage (``ct._mask_pack_batch``, what every single-slice region search runs
on the CPU) at two shapes, with and without the disk-masked threshold, and
the vmapped Scharr. An unvmapped 2D ``scharr`` computes the border columns
of its second pass in fusions of their own (``ops/filters`` docstring):
there the port holds every interior pixel and differs only in those two
columns. ``canny`` is in ``test_torch_edges_morph.py``.
"""

import math

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import ct as tct
from pylinac_tpu_torch.ops import filters as tf
from pylinac_tpu_torch.ops.stats import sqrt_f32
from pylinac_tpu_torch.ops.threshold import cumsum_f32, otsu_threshold_batch

from tests.test_torch_cheese import draw_cirs062m


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


@pytest.fixture(scope="module")
def cirs_vol(tmp_path_factory):
    """The watch-list drawing, as JAX's CIRS062M stages it: (ds, float32
    (20, 512, 512) HU stack)."""
    import pylinac_tpu.cheese as jcheese

    d = tmp_path_factory.mktemp("cirs_watch")
    draw_cirs062m(d, body_mm=(330, 270), insert_mm=30)
    return jcheese.CIRS062M(str(d))._loc_stage_host()


def _unpack(parts, shape):
    """Bit-packed float32 halfwords of ``label_native.pack_mask16`` back to
    bool (B, H, W)."""
    b, h, w = shape
    bits = np.concatenate([np.asarray(p).ravel() for p in parts]).astype(np.uint16)
    bits = bits.reshape(b, h, -1)
    return ((bits[..., None] >> np.arange(16)) & 1).reshape(b, h, -1)[..., :w].astype(bool)


def _jax_stack_stage(jax_cpu, vol, ds):
    """Edges and thresholds of the JAX stack localisation, the same graph
    as ``ct._stack_mask_pack`` with the edges as outputs."""
    import jax.numpy as jnp

    from pylinac_tpu.ops.filters import gaussian_filter, scharr
    from pylinac_tpu.ops.threshold import otsu_threshold

    @jax_cpu.jit
    def stage(raw):
        n, h, w = raw.shape
        pooled = jnp.clip(raw.reshape(n, h // ds, ds, w // ds, ds).mean(axis=(2, 4)), -1000, 1000)
        edges = jax_cpu.vmap(lambda s: gaussian_filter(scharr(s), 1.0))(pooled)
        return pooled, edges, jax_cpu.vmap(otsu_threshold)(edges)

    return [np.asarray(a) for a in stage(jnp.asarray(vol))]


def test_cirs_watch_list_threshold_and_masks_equal_jax(jax_cpu, cirs_vol):
    """Slice 1's threshold is JAX's 84.15375 to the bit; every slice's
    pooled edges, threshold and localisation mask equal JAX's."""
    import jax.numpy as jnp

    import pylinac_tpu.ct as jct

    ds, vol = cirs_vol
    pooled, j_edges, j_thres = _jax_stack_stage(jax_cpu, vol, ds)
    n, h, w = vol.shape
    j_masks = _unpack(jct._stack_mask_pack(jnp.asarray(vol), ds, True)[:-1],
                      (n, h // ds, w // ds))
    np.testing.assert_array_equal(j_masks, j_edges > j_thres[:, None, None])
    assert j_thres[1] == np.float32(84.15375)

    raw = torch.from_numpy(vol)
    t_pooled = raw.reshape(n, h // ds, ds, w // ds, ds).mean(dim=(2, 4)).clamp(-1000, 1000)
    np.testing.assert_array_equal(t_pooled.numpy(), pooled)
    t_masks, t_edges = tct._mask_batch(t_pooled, None, 0.0, use_otsu=True, scale08=False)
    np.testing.assert_array_equal(t_edges.numpy(), j_edges)
    t_thres = otsu_threshold_batch(t_edges)
    np.testing.assert_array_equal(t_thres.numpy(), j_thres)
    assert t_thres[1].item() == np.float32(84.15375)
    np.testing.assert_array_equal(t_masks.numpy(), j_masks)


def _unfused_edges(x):
    """Scharr then a sigma-1 Gaussian over the last two dims with each
    multiply and add rounded on its own: the port's sums before they took
    XLA's contractions."""
    def comp(dim):
        out = x
        for d in (x.dim() - 2, x.dim() - 1):
            out = tf.correlate1d(out, tf._SCHARR_D / 2.0 if d == dim else tf._SCHARR_S, dim=d)
        return out

    h, v = comp(x.dim() - 2), comp(x.dim() - 1)
    out = torch.sqrt(h * h + v * v) / math.sqrt(2.0)
    for d in (-2, -1):
        out = tf.gaussian_filter1d(out, 1.0, dim=d)
    return out


def test_cirs_watch_list_unfused_sums_flip_the_bin(cirs_vol):
    """The fault the fused forms close: with each op rounded and torch's
    float64-accumulated ``cumsum``, slice 1 gets 83.213486."""
    ds, vol = cirs_vol
    n, h, w = vol.shape
    pooled = torch.from_numpy(vol).reshape(n, h // ds, ds, w // ds, ds).mean(dim=(2, 4))
    edges = _unfused_edges(pooled.clamp(-1000, 1000))
    flat = edges[1].reshape(-1)
    vmin, vmax = flat.min(), flat.max()
    span = vmax - vmin
    idx = ((flat - vmin) / span * 256).to(torch.int64).clamp(0, 255)
    hist = torch.zeros(256).scatter_add_(0, idx, torch.ones_like(flat))
    centers = vmin + (torch.arange(256, dtype=torch.float32) + 0.5) * span / 256
    w1 = torch.cumsum(hist, 0)
    mu = torch.cumsum(hist * centers, 0)
    w2 = w1[-1] - w1
    between = w1 * w2 * (mu / w1.clamp(min=1e-20) - (mu[-1] - mu) / w2.clamp(min=1e-20)) ** 2
    between = torch.where((w1 > 0) & (w2 > 0), between, float("-inf"))
    assert centers[between.argmax()].item() == np.float32(83.213486)


@pytest.mark.parametrize("shape", [(3, 96, 120), (2, 257, 200)])
@pytest.mark.parametrize("disk", [False, True])
def test_mask_stage_equals_jax_vmapped(jax_cpu, shape, disk):
    """``_mask_batch`` against ``_mask_pack_batch`` (edges and masks) on
    seeded float images, Otsu with and without the disk, times 0.8."""
    import jax.numpy as jnp

    import pylinac_tpu.ct as jct
    from pylinac_tpu.ops.pack import fetch_concat

    b, h, w = shape
    rng = np.random.default_rng(h)
    yy, xx = np.mgrid[:h, :w]
    body = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (h / 3) ** 2) * 900.0
    arrs = (body + rng.normal(0, 40, (b, h, w))).astype(np.float32)
    cy, cx, rad = h / 2 - 0.5, w / 2 + 0.25, h / 2.5
    flat = np.asarray(fetch_concat(jct._mask_pack_batch(
        jnp.asarray(arrs), np.float32(cy), np.float32(cx), np.float32(rad),
        disk, True, True, True, host=True)))
    ww = -(-w // 16)
    j_masks = _unpack([flat[:b * h * ww]], shape)
    j_edges = flat[b * h * ww:].reshape(shape)
    t_masks, t_edges = tct._mask_batch(torch.from_numpy(arrs), (cy, cx) if disk else None,
                                       rad, use_otsu=True, scale08=True)
    np.testing.assert_array_equal(t_edges.numpy(), j_edges)
    np.testing.assert_array_equal(t_masks.numpy(), j_masks)


@pytest.mark.parametrize("shape", [(2, 64, 80), (3, 131, 97)])
def test_fused_scharr_equals_jax_vmapped(jax_cpu, shape):
    from pylinac_tpu.ops.filters import gaussian_filter, scharr

    rng = np.random.default_rng(sum(shape))
    x = (rng.random(shape) * 3000 - 1000).astype(np.float32)
    j_s = np.asarray(jax_cpu.jit(jax_cpu.vmap(scharr))(x))
    j_e = np.asarray(jax_cpu.jit(jax_cpu.vmap(lambda s: gaussian_filter(scharr(s), 1.0)))(x))
    t_s = tf.scharr(torch.from_numpy(x))
    np.testing.assert_array_equal(t_s.numpy(), j_s)
    t_e = tf.gaussian_filter(t_s, 1.0, dims=(-2, -1))
    np.testing.assert_array_equal(t_e.numpy(), j_e)
    # each op rounded on its own is not XLA's
    assert (_unfused_edges(torch.from_numpy(x)).numpy() != j_e).any()


@pytest.mark.parametrize("shape", [(64, 80), (131, 97)])
def test_fused_scharr_2d_graph_differs_only_in_border_columns(jax_cpu, shape):
    """The measured exception of the unvmapped graph (ROADMAP section 3)."""
    from pylinac_tpu.ops.filters import scharr

    rng = np.random.default_rng(shape[0])
    x = (rng.random(shape) * 3000 - 1000).astype(np.float32)
    j = np.asarray(scharr(x))
    t = tf.scharr(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(t[:, 1:-1], j[:, 1:-1])
    assert (t != j).mean() < 0.02


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0, 3.0])
def test_fused_gaussian_equals_jax_2d(jax_cpu, sigma):
    """The standalone jitted ``gaussian_filter`` (the FC-2 high-pass,
    ``array_utils.filter(kind="gaussian")``, the CT wire-ramp blur), in 2D
    and on a 1D profile."""
    from pylinac_tpu.ops.filters import gaussian_filter

    rng = np.random.default_rng(int(sigma * 10))
    x = (rng.random((90, 110)) * 1000).astype(np.float32)
    j = np.asarray(gaussian_filter(x, sigma))
    t = tf.gaussian_filter(torch.from_numpy(x), sigma)
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(tf.gaussian_filter(torch.from_numpy(x[7]), sigma).numpy(),
                                  np.asarray(gaussian_filter(x[7], sigma)))


@pytest.mark.parametrize("n", [1, 7, 16, 17, 100, 256, 300, 1000])
def test_cumsum_f32_equals_jnp_cumsum(jax_cpu, n):
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    x = (rng.random((3, n)) * 1e4).astype(np.float32)
    j2 = np.asarray(jax_cpu.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    j1 = np.asarray(jax_cpu.jit(jnp.cumsum)(x[0]))
    t = cumsum_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(t, j2)
    np.testing.assert_array_equal(t[0], j1)


def test_sqrt_f32_is_correctly_rounded():
    rng = np.random.default_rng(5)
    x = np.concatenate([(rng.random(200000) * 1e4).astype(np.float32),
                        (rng.random(50000) * 1e-30).astype(np.float32),
                        np.array([0, 1, 2, 4, np.inf, 3e38, 1e-45], np.float32)])
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(sqrt_f32(torch.from_numpy(x)).numpy(), want)
    assert torch.isnan(sqrt_f32(torch.tensor([-1.0, float("nan")]))).all()
