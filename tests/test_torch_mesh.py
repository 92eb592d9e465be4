"""The port's multi-device runtime (``pylinac_tpu_torch/parallel/mesh.py``)
against the JAX package's ``parallel/mesh.py``, on the CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port on
``Mesh([cpu] * 8)``, a logical 8-shard mesh in one process, at the inputs of
``tests/parallel/test_mesh.py`` (uneven batches and a (2, 4) mesh among
them). Bars: picket fence outputs within 1e-5 (JAX's own bar between its
sharded and unsharded runs); gamma maps within 1e-6 with equal NaN masks;
Winston-Lutz centroids within 1e-3 px; CT fits within 1e-4 (slope) and
1e-3 px (intercept), the localisation's centroids within 1e-3 px; field
sizes within 0.01 mm and the mean within 1e-5 relative.

The product APIs (``PicketFenceBatch``, ``FieldAnalysisBatch``,
``gamma_2d_batch``, ``CatPhanBatch``) with a mesh must equal their unsharded
runs bit for bit, padded batches included; the unsharded port is held to JAX
by the other test files. The threaded path (one thread a distinct device)
keeps results in shard order and counts launches and stages exactly.

The ``cuda``-marked tests run each product API on ``Mesh([cuda:0] * 4)``
against the unsharded card run, with the kernels' launches counted:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mesh.py
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import profiling
from pylinac_tpu_torch.ops import _build
from pylinac_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    """JAX's mesh module and its 8-device mesh."""
    pytest.importorskip("jax")
    import jax

    from pylinac_tpu.parallel import mesh as jm

    assert len(jax.devices()) >= 8, "conftest should force the 8-device mesh"
    return SimpleNamespace(m=jm, mesh=jm.make_mesh(8), jax=jax)


@pytest.fixture(scope="module")
def mesh8():
    return tmesh.Mesh([CPU] * 8, ("data",))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.cpu() if isinstance(tree, torch.Tensor) else tree)


def _assert_equal_trees(a, b, path=""):
    """Bit for bit, NaN equal to NaN, keys in the same order."""
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)


# ---------------------------------------------------------------------------
# inputs of tests/parallel/test_mesh.py
# ---------------------------------------------------------------------------
def _tilted_volume(z_total: int, x0: float, slope: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = w = 128
    vol = np.zeros((z_total, h, w), np.float32)
    yy, xx = np.mgrid[:h, :w]
    for z in range(z_total):
        vol[z] = (((yy - 64.0) ** 2 + (xx - (x0 + slope * z)) ** 2) < 40**2) * 1000.0
    return vol + rng.normal(0, 5, vol.shape).astype(np.float32)


def _open_fields(n: int, shape=(100, 130), seed: int = 1) -> np.ndarray:
    imgs = np.random.default_rng(seed).random((n, *shape)).astype(np.float32) * 50
    imgs[:, 30:70, 40:90] += 1000
    return imgs


def _wl_images() -> np.ndarray:
    H = W = 128
    yy, xx = np.mgrid[:H, :W]
    imgs = np.zeros((8, H, W), np.float32)
    for i in range(8):
        field = ((np.abs(yy - 64) < 30) & (np.abs(xx - 64) < 30)) * 1000.0
        bb = 600.0 * np.exp(-0.5 * (((yy - 64 + 2.0) ** 2 + (xx - 64 - 3.0) ** 2) / 3.0**2))
        imgs[i] = field - bb
    return imgs


@pytest.fixture(scope="module")
def pf_inputs(jmesh):
    """The JAX test's synthetic picket batch and configuration, and the
    port's copies of them."""
    from tests.parallel.test_mesh import _make_pf_batch

    from pylinac_tpu_torch.ops.picket_pipeline import leaf_config_from_numpy, params_from_numpy

    imgs, cfg, params = _make_pf_batch(8)
    return SimpleNamespace(imgs=imgs, jcfg=cfg, jparams=params,
                           cfg=leaf_config_from_numpy(cfg, CPU),
                           params=params_from_numpy(params, CPU))


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------
def test_mesh_shape_size_and_devices(jmesh):
    m = tmesh.Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4), ("data", "model"))
    jm2 = jmesh.m.Mesh(np.array(jmesh.jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    assert dict(m.shape) == dict(jm2.shape)
    assert m.size == jm2.devices.size == 8
    assert m.devices.shape == (2, 4)
    assert tmesh.data_devices(m) == [CPU, CPU]
    assert tmesh.Mesh(["cuda"] * 2, ("data",)).first_device == torch.device("cuda", 0)
    with pytest.raises(ValueError):
        tmesh.Mesh([CPU] * 4, ("data", "model"))
    with pytest.raises(ValueError):
        tmesh.data_devices(tmesh.Mesh([CPU] * 2, ("model",)))
    assert tmesh.make_mesh(8, device="cpu").shape == {"data": 8}


@pytest.mark.parametrize("B, n, k", [(3, 1, 1), (3, 2, 2), (3, 8, 8), (3, 8, 2), (16, 3, 3),
                                     (5, 8, 4)])
def test_padded_shards_match_jax_pad_batch(jmesh, B, n, k):
    """The shards joined are JAX's padded batch; shards without pad rows are
    views of the batch."""
    x = np.arange(B * 2 * 2, dtype=np.float32).reshape(B, 2, 2)
    want, wb = jmesh.m._pad_batch(jmesh.jax.numpy.asarray(x), n)
    assert wb == B
    for src in (x, torch.from_numpy(x)):
        shards = tmesh._padded_shards(src, n, k)
        assert len(shards) == k and len({len(s) for s in shards}) == 1
        np.testing.assert_array_equal(np.concatenate([np.asarray(s) for s in shards]),
                                      np.asarray(want))
        size = len(shards[0])
        for i, s in enumerate(shards):
            if (i + 1) * size <= B:
                assert np.shares_memory(np.asarray(s), x)


# ---------------------------------------------------------------------------
# the sharded entries against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("z_total, x0, slope, seed", [(16, 60.0, 0.5, 0), (13, 58.0, 0.4, 4)],
                         ids=["16-on-8", "13-on-8"])
def test_sharded_ct_localization_matches_jax(jmesh, mesh8, z_total, x0, slope, seed):
    vol = _tilted_volume(z_total, x0, slope, seed)
    want = np.asarray(jmesh.m.sharded_ct_localization(vol, jmesh.mesh))
    got = tmesh.sharded_ct_localization(vol, mesh8).numpy()
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-3)
    # and the JAX test's own bars on the drawn axis
    assert got[0, 0] == pytest.approx(0.0, abs=0.05)
    assert got[0, 1] == pytest.approx(64.0, abs=1.5)
    assert got[1, 0] == pytest.approx(slope, abs=0.05)
    assert got[1, 1] == pytest.approx(x0, abs=1.5)


def test_batch_runner_matches_jax_with_padding(jmesh, mesh8):
    """5 images padded to 8: the padded images are masked out of the mean;
    the two stages keep JAX's names."""
    imgs = _open_fields(5)
    want_metrics, want_mean = jmesh.m.QABatchRunner(jmesh.mesh).run(imgs)
    with profiling.collect() as times:
        metrics, mean_size = tmesh.QABatchRunner(mesh8).run(imgs)
    assert [name for name, _ in times.stages] == ["bucket+pad", "sharded_compute"]
    for axis in ("vert", "horiz"):
        got = metrics[axis]["field_size_mm"]
        assert got.shape == (5,)
        np.testing.assert_allclose(got, np.asarray(want_metrics[axis]["field_size_mm"]),
                                   atol=0.01)
    assert mean_size == pytest.approx(want_mean, rel=1e-5)
    assert mean_size == pytest.approx(float(metrics["vert"]["field_size_mm"].mean()), rel=1e-5)
    assert mean_size == pytest.approx(40.0, abs=2)


def test_2x4_mesh_data_axis_matches_jax(jmesh):
    """Only the data axis shards: two replicas of four on a (2, 4) mesh."""
    from jax.sharding import Mesh as JMesh

    imgs = np.random.default_rng(2).random((4, 64, 128)).astype(np.float32) * 10
    imgs[:, 16:48, 32:96] += 1000
    jm2 = JMesh(np.array(jmesh.jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    want, want_mean = jmesh.m.sharded_field_analysis(jmesh.jax.numpy.asarray(imgs), jm2)
    m2 = tmesh.Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4), ("data", "model"))
    got, got_mean = tmesh.sharded_field_analysis(imgs, m2)
    np.testing.assert_allclose(got["vert"]["field_size_mm"].numpy(),
                               np.asarray(want["vert"]["field_size_mm"]), atol=0.01)
    assert float(got_mean[0]) == pytest.approx(float(np.asarray(want_mean)[0]), rel=1e-5)
    assert float(got_mean[0]) == pytest.approx(
        float(got["vert"]["field_size_mm"].mean()), rel=1e-5)


def test_sharded_picket_fence_matches_jax(jmesh, mesh8, pf_inputs):
    import jax.numpy as jnp

    static = dict(K_P=8, W_MAX=64, H_MAX=24, num_pickets=None, peak_sort="peak_heights",
                  separate_leaves=False)
    want = jmesh.m.sharded_picket_fence(jnp.asarray(pf_inputs.imgs), pf_inputs.jcfg,
                                        pf_inputs.jparams, jmesh.mesh, **static)
    got = tmesh.sharded_picket_fence(torch.from_numpy(pf_inputs.imgs), pf_inputs.cfg,
                                     pf_inputs.params, mesh8, **static)
    for key in ("errors_mm", "fits", "kiss_valid", "n_pickets"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   err_msg=key)


def test_sharded_pf_batch_matches_jax_and_unsharded(jmesh, mesh8, pf_inputs):
    """3 images padded to 8 with the product entry's statics; the port's
    sharded run also equals its unsharded ``picket_fence_batch`` bit for
    bit."""
    import jax.numpy as jnp

    from pylinac_tpu_torch.ops.picket_pipeline import picket_fence_batch

    imgs = pf_inputs.imgs[:3]
    static = dict(K_P=8, W_MAX=64, H_MAX=24, num_pickets=None, peak_sort="peak_heights",
                  separate_leaves=False, chunk=32)
    want = jmesh.m.sharded_pf_batch(jnp.asarray(imgs), pf_inputs.jcfg, pf_inputs.jparams,
                                    jmesh.mesh, preprocess=True, **static)
    got = tmesh.sharded_pf_batch(torch.from_numpy(imgs), pf_inputs.cfg, pf_inputs.params,
                                 mesh8, **static)
    for key in ("errors_mm", "fits", "kiss_valid", "n_pickets", "dist2cax_mm"):
        assert got[key].shape[0] == 3
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   err_msg=key)
    plain = picket_fence_batch(torch.from_numpy(imgs), pf_inputs.cfg, pf_inputs.params,
                               **static)
    _assert_equal_trees(got, plain)


def test_sharded_gamma_matches_jax(jmesh, mesh8):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    refs = rng.random((8, 64, 96)).astype(np.float32) * 100
    evals = refs + rng.normal(0, 1, refs.shape).astype(np.float32)
    kw = dict(dose_to_agreement=3.0, distance_to_agreement=3)
    want = np.asarray(jmesh.m.sharded_gamma_2d(jnp.asarray(refs), jnp.asarray(evals),
                                               jmesh.mesh, **kw))
    got = tmesh.sharded_gamma_2d(refs, evals, mesh8, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    both = ~np.isnan(got)
    np.testing.assert_allclose(got[both], want[both], atol=1e-6, rtol=0)


def test_sharded_wl_centroids_matches_jax(jmesh, mesh8):
    import jax.numpy as jnp

    imgs = _wl_images()
    want = np.asarray(jmesh.m.sharded_wl_centroids(jnp.asarray(imgs), jmesh.mesh))
    got = tmesh.sharded_wl_centroids(imgs, mesh8).numpy()
    assert got.shape == (8, 4)
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert np.allclose(got[:, 0], 64, atol=0.5)
    assert np.allclose(got[:, 2] - got[:, 0], -2.0, atol=0.5)
    assert np.allclose(got[:, 3] - got[:, 1], 3.0, atol=0.5)


def test_sharded_fa_strips_batch_matches_jax(jmesh, mesh8):
    """5 images' strips padded to 8, under the FWHM edge."""
    import jax.numpy as jnp

    from pylinac_tpu.ops.field_pipeline import FAParams as JParams

    from pylinac_tpu_torch.ops.field_pipeline import FAParams, field_analysis_strips_batch

    imgs = _open_fields(5, shape=(100, 130), seed=3)
    vert, horiz = imgs[:, :, 62:68].mean(axis=2), imgs[:, 48:52, :].mean(axis=1)
    values = (1.0, 0.8, 0.2, 20.0, 80.0, 0.5, 0.5, 0.0, 0.0)
    static = dict(samples_v=1000, samples_h=1300, edge="FWHM", centering="Beam center",
                  normalization="Beam center", flatness="difference",
                  symmetry="point difference")
    want = jmesh.m.sharded_fa_strips_batch(vert, horiz, JParams(*map(jnp.float32, values)),
                                           jmesh.mesh, **static)
    params = FAParams.from_vector(values, CPU)
    got = tmesh.sharded_fa_strips_batch(vert, horiz, params, mesh8, **static)
    for axis in ("vert", "horiz"):
        np.testing.assert_allclose(got[axis]["field_size_mm"].numpy(),
                                   np.asarray(want[axis]["field_size_mm"]), atol=0.01)
    plain = field_analysis_strips_batch(torch.from_numpy(vert.astype(np.float32)),
                                        torch.from_numpy(horiz.astype(np.float32)), params,
                                        **static)
    _assert_equal_trees(got, plain)


def test_sharded_stack_phantom_regions_matches_jax(jmesh, mesh8):
    """13 slices padded with zero slices to 16: the pad slices are dropped and
    the regions match JAX's in slot, validity and centroid."""
    import jax.numpy as jnp

    from pylinac_tpu.ops import label as jlabel

    from pylinac_tpu_torch.ct import _stack_phantom_regions

    vol = _tilted_volume(13, 58.0, 0.4, 4) - 1000.0
    (main, label_id), want_edges = jmesh.m.sharded_stack_phantom_regions(
        jnp.asarray(vol), 16, True, 2, True, jmesh.mesh)
    want = jlabel.regions_to_host((main, label_id))
    host, max_edges = tmesh.sharded_stack_phantom_regions(torch.from_numpy(vol), 16, True, 2,
                                                         True, mesh8)
    assert host.valid.shape == want.valid.shape == (13, 16)
    np.testing.assert_array_equal(host.valid, want.valid)
    np.testing.assert_array_equal(host.area_filled, want.area_filled)
    for f in ("centroid_r", "centroid_c"):
        np.testing.assert_allclose(getattr(host, f)[host.valid], getattr(want, f)[want.valid],
                                   atol=1e-3)
    np.testing.assert_allclose(max_edges, np.asarray(want_edges).ravel(), rtol=1e-5)
    regions, edges = _stack_phantom_regions(torch.from_numpy(vol), 16, True, 2, True)
    _assert_equal_trees(dict(zip(host._fields, host)),
                        dict(zip(host._fields, regions.to_numpy())))
    np.testing.assert_array_equal(max_edges, edges.numpy())


# ---------------------------------------------------------------------------
# the product APIs: sharded equals unsharded, bit for bit
# ---------------------------------------------------------------------------
def _spike(arr: np.ndarray, seed: int) -> np.ndarray:
    """An EPID-like uint16 frame with hot pixels, which trips the de-spike."""
    rng = np.random.default_rng(seed)
    out = arr.astype(np.float64) * 0.5 + 1000 + rng.normal(0, 2, arr.shape).round()
    out.flat[rng.choice(out.size, out.size // 2000, replace=False)] = 65535
    return np.clip(out, 0, 65535).astype(np.uint16)


@pytest.fixture(scope="module")
def pf_paths(tmp_path_factory):
    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
    from pylinac_tpu_torch.imggen.simulators import AS500Image
    from pylinac_tpu_torch.imggen.utils import generate_picketfence

    tmp = tmp_path_factory.mktemp("torch_pf_mesh")
    paths = []
    for i, err in enumerate(([0] * 6, [0, 0, 0.4, 0, 0, 0])):
        path = str(tmp / f"pf{i}.dcm")
        generate_picketfence(simulator=AS500Image(sid=1500), field_layer=PerfectFieldLayer,
                             file_out=path, final_layers=[GaussianFilterLayer(sigma_mm=1)],
                             pickets=6, picket_spacing_mm=20, picket_width_mm=3,
                             picket_offset_error=list(err))
        paths.append(path)
    return [paths[0], paths[1], paths[0]]


def _pf_batch(paths):
    from pylinac_tpu_torch import PicketFenceBatch

    batch = PicketFenceBatch(paths)
    for i, im in enumerate(batch.images):
        im.array = _spike(im.array, i)
    return batch


def test_picketfence_batch_mesh_equals_unsharded(pf_paths, mesh8):
    """3 spiked frames on 8 shards (padding 3 -> 8)."""
    plain = _pf_batch(pf_paths)
    plain.analyze(tolerance=0.5, device="cpu")
    sharded = _pf_batch(pf_paths)
    sharded.analyze(tolerance=0.5, mesh=mesh8)
    assert plain._out["despike_passes"].min() >= 1
    _assert_equal_trees(sharded._out, plain._out)
    assert _same_but_dates(sharded, plain)


def _same_but_dates(a, b) -> bool:
    strip = [{k: v for k, v in r.items() if k != "date_of_analysis"}
             for r in a.results_data(as_dict=True)]
    return strip == [{k: v for k, v in r.items() if k != "date_of_analysis"}
                     for r in b.results_data(as_dict=True)]


def test_field_analysis_batch_mesh_equals_unsharded(tmp_path, mesh8):
    """5 open fields on 8 shards (padding 5 -> 8)."""
    from pylinac_tpu_torch import FieldAnalysisBatch
    from pylinac_tpu_torch.imggen.layers import FilteredFieldLayer, GaussianFilterLayer
    from pylinac_tpu_torch.imggen.simulators import AS500Image

    paths = []
    for i in range(5):
        sim = AS500Image(sid=1000)
        sim.add_layer(FilteredFieldLayer(field_size_mm=(60 + 10 * i, 60 + 10 * i)))
        sim.add_layer(GaussianFilterLayer(sigma_mm=1))
        paths.append(str(tmp_path / f"f{i}.dcm"))
        sim.generate_dicom(paths[-1])
    plain = FieldAnalysisBatch(paths, device="cpu")
    plain.analyze()
    sharded = FieldAnalysisBatch(paths, device="cpu")
    sharded.analyze(mesh=mesh8)
    _assert_equal_trees(sharded._out, plain._out)
    assert _same_but_dates(sharded, plain)


def test_gamma_2d_batch_mesh_equals_unsharded():
    """8 pairs on 3 shards (padding 8 -> 9), uint16 in."""
    from pylinac_tpu_torch.ops.gamma import gamma_2d_batch

    rng = np.random.default_rng(9)
    refs = (rng.random((8, 40, 52)) * 4000 + 500).astype(np.uint16)
    evals = (refs * rng.normal(1, 0.01, refs.shape)).astype(np.uint16)
    kw = dict(dose_to_agreement=2.0, distance_to_agreement=3)
    plain = gamma_2d_batch(refs, evals, device="cpu", **kw)
    sharded = gamma_2d_batch(refs, evals, mesh=tmesh.Mesh([CPU] * 3, ("data",)), **kw)
    assert sharded.shape == (8, 40, 52)
    _assert_equal_trees(sharded, plain)


@pytest.fixture(scope="module")
def catphan_scan(tmp_path_factory) -> str:
    """The 60-slice scan of ``tests/test_torch_catphan.py``."""
    from pylinac_tpu_torch.imggen.ct import generate_catphan504

    d = tmp_path_factory.mktemp("catphan_mesh")
    generate_catphan504(d, num_slices=60, slice_thickness_mm=2.5)
    return str(d)


def test_catphan_batch_mesh_equals_unsharded(catphan_scan, mesh8):
    """Two scans, 120 slices, localised on 8 shards."""
    from pylinac_tpu_torch.ct import CatPhanBatch

    plain = CatPhanBatch([catphan_scan, catphan_scan])
    plain.analyze(device="cpu")
    sharded = CatPhanBatch([catphan_scan, catphan_scan])
    sharded.analyze(mesh=mesh8)
    for p, s in zip(plain.cts, sharded.cts):
        assert s._slice_centroids == p._slice_centroids
        assert s.origin_slice == p.origin_slice
        assert s.catphan_roll == p.catphan_roll
    want = [{k: v for k, v in r.items() if k != "date_of_analysis"}
            for r in plain.results_data(as_dict=True)]
    got = [{k: v for k, v in r.items() if k != "date_of_analysis"}
           for r in sharded.results_data(as_dict=True)]
    assert got == want


# ---------------------------------------------------------------------------
# threads, counters and the argument rules
# ---------------------------------------------------------------------------
def test_threaded_shards_keep_shard_order_and_count_exactly():
    """Distinct devices run at once, one thread each; shards on one device
    run in order on one thread; results come back in shard order although
    the later shards finish first; stages entered from every thread are all
    recorded, and launch counts made from every thread add up exactly."""
    devices = [torch.device("cpu", i % 4) for i in range(8)]
    seen = []

    class Counted:
        launches = 0

    def fn(device, shard):
        time.sleep(0.02 * (8 - shard))
        with profiling.stage("shard"):
            for _ in range(2000):
                _build.count_launch(Counted)
        seen.append((shard, device, threading.get_ident()))
        return shard * 10

    with profiling.collect() as times:
        out = tmesh.run_shards(devices, fn, list(range(8)))
    assert out == [i * 10 for i in range(8)]
    assert Counted.launches == 8 * 2000
    assert [name for name, _ in times.stages] == ["shard"] * 8
    by_device = {}
    for shard, device, ident in seen:
        by_device.setdefault(device, set()).add(ident)
    assert all(len(ids) == 1 for ids in by_device.values())
    assert len({next(iter(ids)) for ids in by_device.values()}) == 4
    order = [shard for shard, device, _ in seen if device == torch.device("cpu", 1)]
    assert order == [1, 5]


def test_threaded_mesh_products_equal_unsharded(pf_paths):
    """The product APIs on four distinct CPU devices (four threads) equal
    their unsharded runs, and the profiling stages of the batch stay those
    of one run."""
    from pylinac_tpu_torch.ops.gamma import gamma_2d_batch

    threaded = tmesh.Mesh([torch.device("cpu", i) for i in range(4)], ("data",))
    plain = _pf_batch(pf_paths)
    plain.analyze(tolerance=0.5, device="cpu")
    sharded = _pf_batch(pf_paths)
    with profiling.collect() as times:
        sharded.analyze(tolerance=0.5, mesh=threaded)
    _assert_equal_trees(sharded._out, plain._out)
    names = [name for name, _ in times.stages]
    assert names == ["pf.host_orient", "pf.wmax_est", "pf.h2d_stage"]

    rng = np.random.default_rng(10)
    refs = rng.random((6, 24, 30)).astype(np.float32) * 100
    evals = refs + rng.normal(0, 1, refs.shape).astype(np.float32)
    _assert_equal_trees(gamma_2d_batch(refs, evals, mesh=threaded),
                        gamma_2d_batch(refs, evals, device="cpu"))


def test_mesh_argument_rules(pf_paths, catphan_scan, mesh8):
    from pylinac_tpu_torch import CatPhanBatch, FieldAnalysisBatch, PicketFenceBatch
    from pylinac_tpu_torch.ops.gamma import gamma_2d_batch

    with pytest.raises(ValueError, match="differs from the mesh's first device"):
        PicketFenceBatch(pf_paths).analyze(mesh=mesh8, device="cuda")
    with pytest.raises(ValueError, match="differs from the mesh's first device"):
        FieldAnalysisBatch(pf_paths[:1], device="cpu").analyze(mesh=mesh8, device="cuda:1")
    with pytest.raises(ValueError, match="differs from the mesh's first device"):
        CatPhanBatch([catphan_scan]).analyze(mesh=mesh8, device="cuda")
    refs = np.ones((2, 8, 8), np.float32)
    with pytest.raises(ValueError, match="differs from the mesh's first device"):
        gamma_2d_batch(refs, refs, mesh=mesh8, device="cuda")
    # the first device, spelt out, is fine
    gamma_2d_batch(refs, refs, mesh=mesh8, device="cpu:0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_mesh()
        with pytest.raises(RuntimeError):
            gamma_2d_batch(refs, refs, mesh=tmesh.Mesh(["cuda:0"] * 2, ("data",)))
        with pytest.raises(RuntimeError):
            PicketFenceBatch(pf_paths).analyze(mesh=tmesh.Mesh(["cuda:0"] * 2, ("data",)))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tmesh.Mesh([torch.device("cuda", 0)] * 4, ("data",))


def _counts():
    from pylinac_tpu_torch.ops import ccl, flood, gamma2d, median

    return {"median": median.median3x3, "label": ccl.label_batch,
            "holes": ccl.hole_roots_batch, "flood": flood.flood_from_border_batch,
            "gamma": gamma2d.gamma2d}


def _counted(run):
    counters = _counts()
    for c in counters.values():
        c.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items() if c.launches}


@pytest.mark.cuda
def test_picketfence_batch_card_mesh(card_mesh, pf_paths):
    plain = _pf_batch(pf_paths)
    plain.analyze(tolerance=0.5, device="cuda")
    sharded = _pf_batch(pf_paths)
    _, counts = _counted(lambda: sharded.analyze(tolerance=0.5, mesh=card_mesh))
    _assert_equal_trees(sharded._out, plain._out)
    # each of the 4 shards de-spikes while its frames are spiky
    passes = sharded._out["despike_passes"]
    assert counts["median"] >= 4 and counts["median"] >= int(passes.max())


@pytest.mark.cuda
def test_gamma_card_mesh(card_mesh):
    from pylinac_tpu_torch.ops.gamma import gamma_2d_batch

    rng = np.random.default_rng(9)
    refs = (rng.random((8, 96, 130)) * 4000 + 500).astype(np.uint16)
    evals = (refs * rng.normal(1, 0.01, refs.shape)).astype(np.uint16)
    plain = gamma_2d_batch(refs, evals, device="cuda", distance_to_agreement=5)
    sharded, counts = _counted(lambda: gamma_2d_batch(refs, evals, mesh=card_mesh,
                                                      distance_to_agreement=5))
    assert counts == {"gamma": 4}
    _assert_equal_trees(sharded, plain)


@pytest.mark.cuda
def test_catphan_and_wl_card_mesh(card_mesh, catphan_scan):
    from pylinac_tpu_torch.ct import CatPhanBatch

    plain = CatPhanBatch([catphan_scan])
    plain.analyze(device="cuda")
    sharded = CatPhanBatch([catphan_scan])
    _, counts = _counted(lambda: sharded.analyze(mesh=card_mesh))
    assert sharded.cts[0]._slice_centroids == plain.cts[0]._slice_centroids
    # 4 shards of the localisation, then the batch's roll and geometry passes
    assert counts["label"] == counts["holes"] == 4 + 2
    cents, counts = _counted(lambda: tmesh.sharded_wl_centroids(_wl_images(), card_mesh))
    assert counts == {"flood": 4}
    np.testing.assert_allclose(cents.cpu().numpy(),
                               tmesh.sharded_wl_centroids(_wl_images(), tmesh.Mesh(
                                   [CPU] * 4, ("data",))).numpy(), atol=1e-3)
