"""The port's machine-log analyzer against the JAX package's, on the CPU.

Both packages read the same files: the JAX tests' dynalog pair and
trajectory logs (``tests/models/test_log_analyzer.py``'s writers) and the
port's seeded VMAT arc and picket fence logs
(:mod:`pylinac_tpu_torch.imggen.logs`, at a few hundred snapshots here).
``interval_fluence`` and the fluence maps are held to JAX's bit for bit;
the gamma maps at 1e-6, the gamma averages and pass rates, RMS and error
statistics, headers, the CSV export and the text reports exactly; folders,
zips, ``load_log`` and ``anonymize`` by their results; ``PicketFence(log=)``
by ``results_data()`` (JAX's constructor reads ``self.mlc`` before setting
it, so its log is loaded after construction here). The ``cuda`` tests hold
the card's fluence to repeat runs bit for bit and to the CPU within 1e-6 of
the map's maximum:
``python -m pytest --noconftest -m cuda tests/test_torch_log_analyzer.py``.
"""

import os
import shutil
import zipfile

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import log_analyzer as tl
from pylinac_tpu_torch.imggen.logs import (
    write_picket_tlog,
    write_vmat_dynalog_pair,
    write_vmat_tlog,
)
from pylinac_tpu_torch.ops.fluence import interval_fluence


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import pylinac_tpu.log_analyzer as jl
    from pylinac_tpu.ops.fluence import interval_fluence as jfluence
    from tests.models import test_log_analyzer as jtests

    return jl, jfluence, jnp, jtests


def _edges(seed, P, S, W):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, W + 1, (P, S)).astype(np.int32)
    right = np.minimum(left + rng.integers(-3, W // 2 + 2, (P, S)), W).astype(np.int32)
    left[:, : S // 3] = 0                   # edges at 0 ...
    right[:, S // 2: S // 2 + 5] = W        # ... and at the width
    left[0, :] = left[0, 0]                 # a parked pair: one bin for every snapshot
    left[1, ::2] = left[1, -1]              # repeated bins
    mu = (rng.random(S) * 10.0 ** rng.uniform(-6, 1, S)).astype(np.float32)
    mu[::7] = 0
    blocked = rng.random(P) < 0.3
    blocked[2] = True
    return left, right, mu, blocked


@pytest.mark.parametrize("seed,P,S,W", [(0, 3, 50, 40), (1, 60, 400, 4000), (2, 10, 999, 300),
                                        (3, 4, 1, 1)])
def test_interval_fluence_bit_equal_to_jax(jax_side, seed, P, S, W):
    _, jfluence, jnp, _ = jax_side
    left, right, mu, blocked = _edges(seed, P, S, W)
    want = np.array(jfluence(jnp.asarray(left), jnp.asarray(right), jnp.asarray(mu),
                             jnp.asarray(blocked), W))
    got = interval_fluence(torch.from_numpy(left), torch.from_numpy(right),
                           torch.from_numpy(mu), torch.from_numpy(blocked), W).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.fixture(scope="module")
def logs(tmp_path_factory, jax_side):
    """Each log file read by both packages: {name: (path, port log, JAX log)}."""
    jl, _, _, jtests = jax_side
    d = tmp_path_factory.mktemp("logs")
    paths = {
        "dynalog": jtests.write_dynalog_pair(d)["A"],
        "tlog": jtests.write_tlog(d / "T1_log.bin"),
        "tlog static": jtests.write_tlog(d / "T2_log.bin", moving=False),
        "vmat tlog": write_vmat_tlog(d / "V1_arc.bin", n_snap=300, seed=1),
        "vmat dynalog": write_vmat_dynalog_pair(d, n_snap=120, seed=2, name="777_arc")["B"],
    }
    return {k: (p, tl.load_log(p, device="cpu"), jl.load_log(p)) for k, p in paths.items()}


@pytest.mark.parametrize("name", ["dynalog", "tlog", "tlog static", "vmat tlog",
                                  "vmat dynalog"])
def test_log_matches_jax(logs, name):
    path, port, ref = logs[name]
    assert type(port).__name__ == type(ref).__name__
    assert port.treatment_type == ref.treatment_type
    assert port.num_beamholds == ref.num_beamholds
    pm, rm = port.axis_data.mlc, ref.axis_data.mlc
    assert (pm.num_leaves, pm.num_snapshots, pm.num_moving_leaves, pm.hdmlc) == \
           (rm.num_leaves, rm.num_snapshots, rm.num_moving_leaves, rm.hdmlc)
    # with no moving leaf, both packages index with an empty float array
    moving = bool(rm.num_moving_leaves)
    for bank in ("A", "B", "both"):
        assert pm.get_RMS_avg(bank) == rm.get_RMS_avg(bank)
        assert pm.get_RMS_max(bank) == rm.get_RMS_max(bank)
        assert pm.get_RMS_percentile(90, bank) == rm.get_RMS_percentile(90, bank)
        assert pm.get_error_percentile(95, bank) == rm.get_error_percentile(95, bank)
    assert pm.get_error_percentile(90, only_moving_leaves=moving) == \
           rm.get_error_percentile(90, only_moving_leaves=moving)
    assert pm.get_RMS_avg(only_moving_leaves=moving) == rm.get_RMS_avg(only_moving_leaves=moving)
    assert np.array_equal(pm.get_snapshot_values("A", "expected"),
                          rm.get_snapshot_values("A", "expected"))
    for kind in ("actual", "expected"):
        for res, eq in ((0.1, False), (0.5, True)):
            a = getattr(port.fluence, kind).calc_map(resolution=res, equal_aspect=eq)
            b = getattr(ref.fluence, kind).calc_map(resolution=res, equal_aspect=eq)
            assert a.dtype == b.dtype and np.array_equal(a, b), (kind, res, eq)
    g = port.fluence.gamma.calc_map(doseTA=2, distTA=1.5, threshold=0.2, resolution=0.5)
    h = ref.fluence.gamma.calc_map(doseTA=2, distTA=1.5, threshold=0.2, resolution=0.5)
    np.testing.assert_allclose(g, h, rtol=0, atol=1e-6)
    assert port.fluence.gamma.avg_gamma == pytest.approx(ref.fluence.gamma.avg_gamma, abs=1e-9)
    assert port.fluence.gamma.pass_prcnt == ref.fluence.gamma.pass_prcnt
    for a, b in zip(port.fluence.gamma.histogram(), ref.fluence.gamma.histogram()):
        assert np.array_equal(a, b)
    port.fluence.gamma._cache_key = ref.fluence.gamma._cache_key = None
    for f in (port.fluence.actual, port.fluence.expected, ref.fluence.actual,
              ref.fluence.expected):
        f.array = np.empty((0, 0))
    assert port.report_basic_parameters(printout=False) == \
           ref.report_basic_parameters(printout=False)


def test_tlog_header_subbeams_and_csv(logs, tmp_path):
    _, port, ref = logs["vmat tlog"]
    for field in ("header", "version", "header_size", "sampling_interval", "num_axes",
                  "num_mlc_leaves", "axis_scale", "num_subbeams", "is_truncated",
                  "num_snapshots", "mlc_model"):
        assert getattr(port.header, field) == getattr(ref.header, field), field
    sp, sr = port.subbeams[0], ref.subbeams[0]
    assert (sp.control_point, sp.mu_delivered, sp.beam_name, sp._snapshots) == \
           (sr.control_point, sr.mu_delivered, sr.beam_name, sr._snapshots)
    assert sp.gantry_angle.actual == sr.gantry_angle.actual
    assert np.array_equal(sp.fluence.actual.calc_map(), sr.fluence.actual.calc_map())
    a = port.to_csv(str(tmp_path / "port"))
    b = ref.to_csv(str(tmp_path / "jax"))
    with open(a) as fa, open(b) as fb:
        assert fa.read().replace(a, "") == fb.read().replace(b, "")


def test_folders_zips_and_loaders(tmp_path, jax_side):
    jl, _, _, jtests = jax_side
    folder = tmp_path / "logs"
    folder.mkdir()
    write_vmat_tlog(folder / "V1_arc.bin", n_snap=200, seed=3)
    jtests.write_tlog(folder / "T9_log.bin")
    write_vmat_dynalog_pair(folder, n_snap=100, seed=4, name="55_arc")
    jtests.write_dynalog_pair(folder)
    port, ref = tl.MachineLogs(str(folder), device="cpu"), jl.MachineLogs(str(folder))
    assert (port.num_logs, port.num_tlogs, port.num_dlogs) == (4, 2, 2)
    assert [os.path.basename(x.filename) for x in port] == \
           [os.path.basename(x.filename) for x in ref]
    kw = {"doseTA": 1.5, "distTA": 2, "threshold": 0.05, "resolution": 0.5}
    assert port.avg_gamma(**kw) == pytest.approx(ref.avg_gamma(**kw), abs=1e-9)
    assert port.avg_gamma_pct(**kw) == ref.avg_gamma_pct(**kw)
    zpath = tmp_path / "logs.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for f in sorted(os.listdir(folder)):
            z.write(folder / f, f)
    zipped = tl.load_log(str(zpath), device="cpu")
    assert isinstance(zipped, tl.MachineLogs) and zipped.num_logs == 4
    assert isinstance(tl.load_log(str(folder / "V1_arc.bin"), device="cpu"), tl.TrajectoryLog)
    assert isinstance(tl.load_log(str(folder), device="cpu"), tl.MachineLogs)
    assert tl.is_tlog(str(folder / "V1_arc.bin")) and not tl.is_dlog(str(folder / "V1_arc.bin"))
    junk = tmp_path / "junk.txt"
    junk.write_text("not a log")
    with pytest.raises(tl.NotALogError):
        tl.load_log(str(junk), device="cpu")
    port[0].publish_pdf(str(tmp_path / "x.pdf"))
    assert (tmp_path / "x.pdf").read_bytes().startswith(b"%PDF")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tl.load_log(str(folder / "V1_arc.bin"))
    # anonymize: the same files, the same contents, in both packages
    outs = {}
    for name, mod in (("port", tl), ("jax", jl)):
        src, dst = tmp_path / f"src_{name}", tmp_path / f"dst_{name}"
        shutil.copytree(folder, src)
        dst.mkdir()
        mod.anonymize(str(src), destination=str(dst))
        outs[name] = {f: (dst / f).read_bytes() for f in sorted(os.listdir(dst))}
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 6


def test_picket_fence_from_log_matches_jax(tmp_path, jax_side):
    import pylinac_tpu.picketfence as jp

    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
    from pylinac_tpu_torch.imggen.simulators import AS500Image
    from pylinac_tpu_torch.imggen.utils import generate_picketfence
    import pylinac_tpu_torch.picketfence as tp

    img = str(tmp_path / "pf.dcm")
    generate_picketfence(simulator=AS500Image(sid=1000), field_layer=PerfectFieldLayer,
                         file_out=img, final_layers=[GaussianFilterLayer(sigma_mm=1)],
                         pickets=10, picket_spacing_mm=20, picket_width_mm=3,
                         picket_offset_error=[0, 0, 0.5] + [0] * 7)
    log = write_picket_tlog(tmp_path / "PF_log.bin", list(range(-90, 91, 20)))
    ref = jp.PicketFence(img)
    ref._load_log(log)
    ref.analyze(tolerance=0.6, separate_leaves=False)
    port = tp.PicketFence(img, log=log, device="cpu")
    port.analyze(tolerance=0.6, separate_leaves=False)
    a, b = port.results_data(as_dict=True), ref.results_data(as_dict=True)
    a.pop("date_of_analysis"), b.pop("date_of_analysis")
    assert a == b
    assert [p.fit.coefficients.tolist() for p in port.pickets] == \
           [p.fit.coefficients.tolist() for p in ref.pickets]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,P,S,W", [(1, 60, 4000, 4000), (2, 10, 999, 300)])
def test_card_fluence_repeats_and_matches_cpu(cuda, seed, P, S, W):
    left, right, mu, blocked = _edges(seed, P, S, W)
    args = [torch.from_numpy(x) for x in (left, right, mu, blocked)]
    cpu = interval_fluence(*args, W)
    first = interval_fluence(*[a.to(cuda) for a in args], W)
    for _ in range(10):
        assert torch.equal(interval_fluence(*[a.to(cuda) for a in args], W), first)
    assert (first.cpu() - cpu).abs().max() <= 1e-6 * cpu.abs().max()


@pytest.mark.cuda
def test_card_log_matches_cpu(cuda, tmp_path):
    path = write_vmat_tlog(tmp_path / "V_arc.bin", n_snap=4000, seed=5)
    card, cpu = tl.load_log(path, device="cuda"), tl.load_log(path, device="cpu")
    a, b = card.fluence.actual.calc_map(), cpu.fluence.actual.calc_map()
    assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    g, h = card.fluence.gamma.calc_map(), cpu.fluence.gamma.calc_map()
    np.testing.assert_allclose(g, h, rtol=0, atol=1e-5)
    assert card.fluence.gamma.pass_prcnt == pytest.approx(cpu.fluence.gamma.pass_prcnt, abs=0.1)
