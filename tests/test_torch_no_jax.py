"""The port runs with neither jax nor pydantic importable.

A child interpreter installs a meta-path finder that refuses ``jax``,
``jaxlib``, ``pydantic`` and ``matplotlib`` (the machine with the card has
none of them), imports ``pylinac_tpu_torch`` and
``pylinac_tpu_torch.ct``, makes a small AS500 picket fence with the port's
own image generator and analyses it on the CPU, finds the regions of a
small ring image with the CT region finder, analyses a small generated
Winston-Lutz set (four AS500 frames) with ``pylinac_tpu_torch.winston_lutz``
on the CPU, takes the 2D gamma of a 32x32 pair with
``pylinac_tpu_torch.ops.gamma``, and analyses a small AS500 open field
with ``FieldAnalysisBatch`` and ``FieldAnalysis`` on the CPU, two small
stars with ``StarshotBatch`` and the single-image ``Starshot``, and the
picket fence with the single-image ``PicketFence``, and a 2-BB AS500
multi-target set with ``WinstonLutzMultiTargetMultiField``, a small
CatPhan 700 from a zip of JPEG Lossless slices (memory-efficient mode), a
Winston-Lutz test from a small JPEG-LS CBCT, the single picket fence's
captured warning, a Varian .xim image written and read back through the
native decoder (``native/xim_decode.cpp``), a DRGS and a DRCS pair, a DLG
image and a 40-slice Quart DVT, a small QC-3 and FC-2 (AS500) and a
``FieldProfileAnalysis`` of an AS500 open field, a ``PlanarUniformity`` of
a 128 x 128 flood and a trajectory log's fluence, with the picket fence's
stages timed by ``pylinac_tpu_torch.profiling``, a TG-51 photon worksheet
and its PDF, and a small TrueBeam plan and its fluence, then the multi-device
runtime (``pylinac_tpu_torch.parallel``: the picket fence batch, the gamma
batch and ``QABatchRunner`` on a two-shard CPU mesh) and the picket fence's
reports that need no matplotlib (``publish_pdf``, ``to_quaac``,
``plotly_analyzed_images`` through ``core/plotly_utils.py``, with
``settings.py`` imported), while its matplotlib plot raises, on the CPU: the
native codecs build and run without any of these packages.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CHILD = textwrap.dedent("""
    import importlib.abc, json, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "pydantic", "matplotlib")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    torch.set_num_threads(2)
    import pylinac_tpu_torch
    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
    from pylinac_tpu_torch.imggen.simulators import AS500Image
    from pylinac_tpu_torch.imggen.utils import generate_picketfence

    path = tempfile.mkdtemp() + "/pf.dcm"
    generate_picketfence(AS500Image(sid=1500), PerfectFieldLayer, path,
                         final_layers=[GaussianFilterLayer(sigma_mm=1)],
                         pickets=8, picket_spacing_mm=20, picket_width_mm=3)
    (result,) = pylinac_tpu_torch.analyze_batch([path], tolerance=0.5, device="cpu")

    import numpy as np
    import pylinac_tpu_torch.ct as ct
    yy, xx = np.mgrid[:64, :64]
    ring = np.where(np.abs(np.hypot(yy - 32, xx - 32) - 15) < 3, 1000.0, 0.0)
    _, regions, n = ct.get_regions(ring, clear_borders=False, device="cpu")

    from pylinac_tpu_torch.imggen.simulators import AS500Image
    from pylinac_tpu_torch.imggen.utils import generate_winstonlutz
    from pylinac_tpu_torch.winston_lutz import WinstonLutz
    wl_dir = tempfile.mkdtemp() + "/wl"
    generate_winstonlutz(AS500Image(sid=1000), PerfectFieldLayer, wl_dir,
                         final_layers=[GaussianFilterLayer(sigma_mm=1)], offset_mm_left=1)
    wl = WinstonLutz(wl_dir)
    wl.analyze(device="cpu")
    wl_data = wl.results_data()

    from pylinac_tpu_torch.ops.gamma import gamma_2d
    dose = (np.random.default_rng(0).random((32, 32)) * 100 + 10).astype(np.float32)
    g = gamma_2d(dose, dose * np.float32(1.01), dose_to_agreement=2.0,
                 distance_to_agreement=2, device="cpu").numpy()
    from pylinac_tpu_torch import FieldAnalysis, FieldAnalysisBatch
    from pylinac_tpu_torch.imggen.layers import FilteredFieldLayer
    fa_path = tempfile.mkdtemp() + "/fa.dcm"
    sim = AS500Image(sid=1000)
    sim.add_layer(FilteredFieldLayer(field_size_mm=(100, 100)))
    sim.add_layer(GaussianFilterLayer(sigma_mm=1))
    sim.generate_dicom(fa_path)
    fa_batch = FieldAnalysisBatch([fa_path, fa_path], device="cpu")
    fa_batch.analyze(device="cpu")
    fa_data = fa_batch.results_data()
    fa_single = FieldAnalysis(fa_path)
    fa_single.analyze(edge_detection_method="FWHM")
    from pylinac_tpu_torch import PicketFence, Starshot, StarshotBatch
    from pylinac_tpu_torch.imggen.utils import make_starshot
    star_dir = tempfile.mkdtemp()
    stars = [make_starshot(star_dir, center=(250, 260), size=(500, 520), name=f"{i}.dcm",
                           angles_offset=10.0 + i) for i in range(2)]
    star_batch = StarshotBatch(stars)
    star_batch.analyze(device="cpu")
    star = Starshot(stars[0])
    star.analyze()
    pf_single = PicketFence(path, device="cpu")
    pf_single.analyze(tolerance=0.5)
    from pylinac_tpu_torch import BBConfig, WinstonLutzMultiTargetMultiField
    from pylinac_tpu_torch.imggen.utils import generate_winstonlutz_multi_bb_multi_field
    mt_dir = tempfile.mkdtemp() + "/mtmf"
    generate_winstonlutz_multi_bb_multi_field(
        AS500Image(sid=1000), PerfectFieldLayer, mt_dir, field_offsets=[(0, 0, 0), (-20, 0, 30)],
        bb_offsets=[(0, 0, 0), (-20, 0, 30)], final_layers=[GaussianFilterLayer(sigma_mm=1)])
    mt = WinstonLutzMultiTargetMultiField(mt_dir)
    mt.analyze((BBConfig("Iso", 0, 0, 0, 5, 20), BBConfig("1", -20, 0, 30, 5, 20)), device="cpu")
    mt_data = mt.results_data()

    import zipfile
    from pylinac_tpu_torch import CatPhan700
    from pylinac_tpu_torch.core import dcm
    from pylinac_tpu_torch.core import image as timage
    from pylinac_tpu_torch.imggen.ct import _generate_catphan700, _generate_cbct_bb
    ct_dir = tempfile.mkdtemp()
    ct_paths = _generate_catphan700(ct_dir, num_slices=40, slice_thickness_mm=5,
                                    mm_per_pixel=1.0, image_size=256,
                                    transfer_syntax=dcm.JPEG_LOSSLESS_SV1)
    with zipfile.ZipFile(ct_dir + "/ct.zip", "w") as zf:
        for p in ct_paths:
            zf.write(p, p.rsplit("/", 1)[1])
    cp700 = CatPhan700.from_zip(ct_dir + "/ct.zip", memory_efficient_mode=True)
    cp700.analyze(device="cpu")
    cp700_data = cp700.results_data()
    cbct_dir = tempfile.mkdtemp()
    _generate_cbct_bb(cbct_dir, num_slices=40, image_size=128,
                      transfer_syntax=dcm.JPEG_LS_LOSSLESS)
    cbct = WinstonLutz.from_cbct(cbct_dir)
    cbct.analyze(bb_size_mm=5, device="cpu")
    cbct_data = cbct.results_data()
    # one leaf pair blanked from the middle picket: the analysis warns
    img = timage.DicomImage(path)
    a = img.array.copy()
    prof = a.mean(axis=0)
    cols = np.nonzero(prof > (prof.max() + prof.min()) / 2)[0]
    runs = np.split(cols, np.nonzero(np.diff(cols) > 1)[0] + 1)
    mid, row = runs[len(runs) // 2], a.shape[0] // 2
    a[row - 6:row + 6, mid[0] - 5:mid[-1] + 6] = np.median(a[:, :runs[0][0] - 10])
    img.array = a
    pf_warn = PicketFence(img.save(tempfile.mkdtemp() + "/pf_missing.dcm"), device="cpu")
    pf_warn.analyze(tolerance=0.5)
    from pylinac_tpu_torch import DLG, DRCS, DRGS, MLC, QuartDVT
    from pylinac_tpu_torch.core.xim import write_xim
    from pylinac_tpu_torch.imggen.ct import generate_quart
    from pylinac_tpu_torch.imggen.utils import _generate_dlg, _generate_vmat_pair
    xim_path = tempfile.mkdtemp() + "/img.xim"
    xim_arr = np.random.default_rng(1).integers(0, 60000, (40, 50)).astype(np.int32)
    write_xim(xim_path, xim_arr, {"PixelWidth": 0.0336, "PixelHeight": 0.0336})
    xim = timage.load(xim_path)
    vmat_dir = tempfile.mkdtemp()
    drgs = DRGS(image_paths=_generate_vmat_pair("drgs", AS500Image(sid=1000), vmat_dir),
                device="cpu")
    drgs.analyze()
    drcs = DRCS(image_paths=_generate_vmat_pair("drcs", AS500Image(sid=1000), vmat_dir),
                device="cpu")
    drcs.analyze()
    dlg_path = tempfile.mkdtemp() + "/dlg.dcm"
    _generate_dlg(AS500Image(sid=1000), dlg_path)
    dlg = DLG(dlg_path)
    dlg.analyze(gaps=(-0.4, -0.6, -0.8, -1.0, -1.2), mlc=MLC.MILLENNIUM)
    quart_dir = tempfile.mkdtemp()
    generate_quart(quart_dir, num_slices=40)
    quart = QuartDVT(quart_dir)
    quart.analyze(device="cpu")
    quart_data = quart.results_data()
    import warnings
    from PIL import Image
    from pylinac_tpu_torch import ACRCT, ACRMRILarge, GEHeliosCTDaily, TomoCheese
    from pylinac_tpu_torch.imggen.ct import generate_acr_ct, generate_helios, generate_tomocheese
    from pylinac_tpu_torch.imggen.mri import generate_acr_mri
    small = {}
    for name, gen, cls, kw in (
            ("acr_ct", generate_acr_ct, ACRCT,
             {"num_slices": 28, "image_size": 256, "mm_per_pixel": 1.0}),
            ("acr_mri", generate_acr_mri, ACRMRILarge, {"image_size": 256, "mm_per_pixel": 1.0}),
            ("tomo", generate_tomocheese, TomoCheese,
             {"num_slices": 12, "image_size": 256, "mm_per_pixel": 1.6}),
            ("helios", generate_helios, GEHeliosCTDaily,
             {"num_slices": 24, "slice_thickness_mm": 5, "image_size": 256,
              "mm_per_pixel": 1.0})):
        series = tempfile.mkdtemp()
        gen(series, **kw)
        obj = cls(series)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            obj.analyze(device="cpu")
            small[name] = obj.results_data(as_dict=True)
    png = tempfile.mkdtemp() + "/img.png"
    Image.fromarray(np.arange(48, dtype=np.uint8).reshape(6, 8)).save(png, dpi=(100, 100))
    png_img = timage.load(png)

    from pylinac_tpu_torch.imggen.layers import FilteredFieldLayer
    from pylinac_tpu_torch.imggen.utils import generate_lightrad
    from tests.test_torch_planar import draw_qc3
    qc3 = pylinac_tpu_torch.StandardImagingQC3(
        draw_qc3(tempfile.mkdtemp() + "/qc3.dcm", sim=AS500Image(sid=1000)))
    qc3.analyze(device="cpu")
    fc2_path = tempfile.mkdtemp() + "/fc2.dcm"
    generate_lightrad(AS500Image(sid=1000), file_out=fc2_path, field_size_mm=(100, 100),
                      bb_size_mm=4, final_layers=[GaussianFilterLayer(sigma_mm=1)])
    fc2 = pylinac_tpu_torch.StandardImagingFC2(fc2_path)
    fc2.analyze(bb_edge_threshold_mm=15, device="cpu")
    fpa_path = tempfile.mkdtemp() + "/open.dcm"
    sim = AS500Image(sid=1000)
    sim.add_layer(FilteredFieldLayer(field_size_mm=(100, 100)))
    sim.add_layer(GaussianFilterLayer(sigma_mm=1))
    sim.generate_dicom(fpa_path)
    fpa = pylinac_tpu_torch.FieldProfileAnalysis(fpa_path)
    fpa.analyze(edge_type="FWHM")
    from pylinac_tpu_torch import log_analyzer, nuclear, profiling
    from pylinac_tpu_torch.core import dcm as tdcm
    from pylinac_tpu_torch.imggen.logs import write_vmat_tlog
    nm = tdcm.Dataset()
    nm.SOPClassUID = "1.2.840.10008.5.1.4.1.1.20"
    nm.SOPInstanceUID = tdcm.generate_uid()
    nm.Modality = "NM"
    nm.PixelSpacing = [4.8, 4.8]
    flood = np.zeros((128, 128))
    flood[14:114, 14:114] = 1000 + np.random.default_rng(2).normal(0, 10, (100, 100))
    nm.set_pixel_data(flood.astype(np.uint16)[None])
    nm_path = tempfile.mkdtemp() + "/flood.dcm"
    tdcm.dcmwrite(nm_path, nm)
    pu = nuclear.PlanarUniformity(nm_path)
    with profiling.collect() as stage_times:
        pu.analyze(device="cpu")
        pylinac_tpu_torch.analyze_batch([path], tolerance=0.5, device="cpu")
    tlog = log_analyzer.load_log(write_vmat_tlog(tempfile.mkdtemp() + "/T_arc.bin", n_snap=100),
                                 device="cpu")
    tlog_map = tlog.fluence.actual.calc_map()
    from pylinac_tpu_torch import TrueBeamPlanGenerator, generate_fluences, tg51
    sheet = tg51.TG51Photon(unit="TB1", chamber="30013", temp=22, press=101.33, n_dw=5.555,
                            p_elec=1.0, measured_pdd10=66.0, clinical_pdd10=66.0, energy=6,
                            voltage_reference=-300, voltage_reduced=-150,
                            m_reference=(25.65,), m_opposite=(-25.66,), m_reduced=(25.64,),
                            mu=200)
    pdf_path = tempfile.mkdtemp() + "/tg51.pdf"
    sheet.publish_pdf(pdf_path)
    plan = tdcm.Dataset()
    plan.Modality = "RTPLAN"
    plan.PatientName = "QA^Physics"
    plan.PatientID = "QA1"
    tol = tdcm.Dataset()
    tol.ToleranceTableNumber = 1
    plan.ToleranceTableSequence = [tol]
    beam, leaves = tdcm.Dataset(), tdcm.Dataset()
    beam.TreatmentMachineName = "TB1"
    leaves.RTBeamLimitingDeviceType = "MLCX"
    leaves.NumberOfLeafJawPairs = 60
    leaves.LeafPositionBoundaries = list(range(-200, -99, 10)) + list(range(-95, 96, 5)) \
        + list(range(100, 201, 10))
    beam.BeamLimitingDeviceSequence = [leaves]
    plan.BeamSequence = [beam]
    pg = TrueBeamPlanGenerator(plan, plan_label="QA", plan_name="QA")
    pg.add_open_field_beam(x1=-50, x2=50, y1=-50, y2=50, mu=100)
    fl = generate_fluences(pg.as_dicom(), width_mm=200, resolution_mm=1, dtype=np.float32,
                           device="cpu")
    from pylinac_tpu_torch import settings
    from pylinac_tpu_torch.parallel import QABatchRunner
    from pylinac_tpu_torch.parallel.mesh import Mesh
    mesh2 = Mesh([torch.device("cpu")] * 2, ("data",))
    pf_mesh = pylinac_tpu_torch.PicketFenceBatch([path, path, path])
    pf_mesh.analyze(tolerance=0.5, mesh=mesh2)
    g_mesh = pylinac_tpu_torch.gamma_2d_batch(
        np.stack([dose] * 3), np.stack([dose * np.float32(1.01)] * 3), dose_to_agreement=2.0,
        distance_to_agreement=2, mesh=mesh2).numpy()
    fields = np.zeros((3, 64, 80), np.float32)
    fields[:, 16:48, 20:60] = 1000
    _, runner_mean = QABatchRunner(mesh2).run(fields)
    report_dir = tempfile.mkdtemp()
    pf_single.publish_pdf(report_dir + "/pf.pdf")
    pf_single.to_quaac(report_dir + "/pf.json")
    pf_figs = pf_single.plotly_analyzed_images(show=False)
    try:
        pf_single.plot_analyzed_image(show=False)
        plot_error = None
    except ImportError as e:
        plot_error = type(e).__name__
    print(json.dumps({
        "mesh": [pf_mesh.results_data()[2].number_of_pickets, bool(np.isnan(g_mesh).any()),
                 float(np.abs(g_mesh - g[None]).max()), runner_mean],
        "reports": [open(report_dir + "/pf.pdf", "rb").read(5).decode(),
                    len(json.load(open(report_dir + "/pf.json"))["datapoints"]),
                    sorted(pf_figs), len(pf_figs["Picket Fence"].to_json()) > 1000,
                    plot_error, settings.get_dicom_cmap()],
        "tg51": [round(sheet.dose_mu_dmax, 4), open(pdf_path, "rb").read(5).decode()],
        "plan_fluence": [list(fl.shape), float(fl[0, 200, 100]), float(fl[0, 200, 5])],
        "nm_uniformity": pu.results_data(as_dict=True)["Frame 1"]["ufov_integral_uniformity"],
        "tlog": [list(tlog_map.shape), float(tlog_map.max()), tlog.treatment_type],
        "stages": sorted(stage_times.as_dict()),
        "qc3": [len(qc3.results_data().low_contrast_rois), round(qc3.phantom_angle, 3)],
        "fc2": [fc2.results_data().field_size_x_mm, fc2.results_data().field_bb_offset_y_mm],
        "fpa": fpa.results_data().x_metrics["Field Width (mm)"],
        "acr_ct": [small["acr_ct"]["phantom_model"], small["acr_ct"]["ct_module"]["rois"]["Air"]],
        "acr_mri": [small["acr_mri"]["num_images"],
                    len(small["acr_mri"]["sagittal_localizer_module"]["profiles"]),
                    small["acr_mri"]["geometric_distortion_module"]["profiles"]["horizontal"][
                        "width (mm)"]],
        "tomo": [small["tomo"]["num_images"], small["tomo"]["rois"]["6"]["median"]],
        "helios": [small["helios"]["phantom_model"], small["helios"]["origin_slice"]],
        "png": [type(png_img).__name__, int(png_img.array.sum()), round(png_img.dpi, 3)],
        "xim": [type(xim).__name__, bool((xim.array == xim_arr).all()), round(xim.dpmm, 6)],
        "vmat": [drgs.results_data().passed, len(drgs.segments), drcs.results_data().passed,
                 sorted(drcs.results_data().collimator_data)],
        "dlg": [len(dlg.measured_dlg_per_leaf), dlg.measured_dlg],
        "quart": [quart_data.phantom_model, quart_data.num_images,
                  quart_data.geometric_module.distances["horizontal mm"]],
        "cp700": [cp700_data.catphan_model, cp700_data.num_images,
                  type(cp700.dicom_stack).__name__, len(cp700_data.ctp404.hu_rois),
                  cp700_data.ctp528.start_angle_radians],
        "cbct": [len(cbct.images), cbct_data.max_2d_cax_to_bb_mm,
                 [cbct.bb_shift_vector.x, cbct.bb_shift_vector.y, cbct.bb_shift_vector.z]],
        "pf_warnings": [(w["message"][:28], w["category"]) for w in
                        pf_warn.results_data().warnings],
        "mtmf": [mt_data.num_total_images, mt_data.max_2d_field_to_bb_mm, list(mt_data.bb_maxes)],
        "star_centres": [r.circle_center_x_y for r in star_batch.results_data()]
                        + [star.results_data().circle_center_x_y],
        "star_diameters": [r.circle_diameter_mm for r in star_batch.results_data()]
                          + [star.results_data().circle_diameter_mm],
        "pf_single": [pf_single.results_data().number_of_pickets,
                      pf_single.results_data().max_error_mm],
        "fa_sizes": [fa_data[0].field_size_vertical_mm, fa_data[1].field_size_horizontal_mm,
                     fa_single.results_data().field_size_horizontal_mm],
        "gamma_shape": list(g.shape), "gamma_finite": int(np.isfinite(g).sum()),
        "gamma_max": float(np.nanmax(g)),
        "wl_images": wl_data.num_total_images, "wl_shift_x": wl_data.bb_shift_vector["x"],
        "ct_regions": n, "ct_filled": max(r.filled_area for r in regions),
        "pickets": result.number_of_pickets, "passed": result.passed,
        "max_error_mm": result.max_error_mm,
        "loaded": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("pylinac_tpu",)),
    }))
""")


def test_port_runs_without_jax_or_pydantic():
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["pickets"] == 8
    assert out["passed"]
    assert out["max_error_mm"] < 0.1
    assert out["ct_regions"] >= 1
    assert out["ct_filled"] > 500  # the ring's edge band with its hole filled
    assert out["wl_images"] == 4
    assert abs(out["wl_shift_x"] - 1) < 0.3  # the BB 1 mm left: shift RIGHT 1 mm
    assert out["gamma_shape"] == [32, 32]
    assert out["gamma_finite"] == 32 * 32  # every pixel is above the 5 % threshold
    assert out["gamma_max"] < 0.6  # a 1 % dose difference against a 2 % criterion
    assert all(abs(size - 100) < 1.0 for size in out["fa_sizes"])  # a 100 mm field
    for x, y in out["star_centres"]:  # every spoke drawn through (250, 260)
        assert abs(x - 250) < 0.1 and abs(y - 260) < 0.1
    assert all(d < 0.05 for d in out["star_diameters"])
    assert out["pf_single"][0] == 8 and out["pf_single"][1] < 0.1
    # the mesh's runs: the padded picket batch, the gamma maps equal to the
    # single pair's, the mean field size of the 32-row fields
    assert out["mesh"][:3] == [8, False, 0.0]
    assert abs(out["mesh"][3] - 32) < 2
    assert out["reports"] == ["%PDF-", 6, ["Histogram", "Picket Fence"], True, "ImportError",
                              "gray"]
    # within half an AS500 pixel (0.78 mm at the isocentre) of the fields
    assert out["mtmf"][0] == 4 and out["mtmf"][1] < 0.4 and out["mtmf"][2] == ["Iso", "1"]
    # a lazy zip of JPEG Lossless slices through the native decoder
    assert out["cp700"] == ["700", 40, "LazyZipDicomImageStack", 11, None]
    # a JPEG-LS CBCT: the BB (2, -1, 3) mm off, as at full size
    assert out["cbct"][0] == 4 and abs(out["cbct"][1] - 3.61) < 0.2
    assert all(abs(a - b) < 0.2 for a, b in zip(out["cbct"][2], (1.0, -3.0, -2.0)))
    assert out["pf_warnings"] == [["Some leaves were removed fro", "UserWarning"]]
    assert out["xim"] == ["XIM", True, round(1 / 0.336, 6)]
    assert out["vmat"] == [True, 7, True, ["A", "B", "C", "D", "E", "F"]]
    assert out["dlg"][0] > 10 and abs(out["dlg"][1]) < 0.15
    assert out["quart"][:2] == ["Quart DVT", 40] and abs(out["quart"][2] - 160) < 2
    assert out["acr_ct"][0] == "ACR CT 464" and abs(out["acr_ct"][1] + 1000) < 15
    assert out["acr_mri"][:2] == [11, 4] and abs(out["acr_mri"][2] - 200) < 4
    assert out["tomo"][0] == 12 and abs(out["tomo"][1] - 800) < 15
    assert out["helios"] == ["GE Helios CT Daily", 8]
    assert out["png"] == ["FileImage", sum(range(48)), 100.0]
    assert out["qc3"] == [5, 45]
    assert abs(out["fc2"][0] - 100) < 1.5 and abs(out["fc2"][1]) < 1.0
    assert abs(out["fpa"] - 100) < 1.0
    assert 0 < out["nm_uniformity"] < 15
    assert out["tlog"][0] == [60, 4000] and 0 < out["tlog"][1] <= 600
    assert 1.0 < out["tg51"][0] < 1.2 and out["tg51"][1] == "%PDF-"
    assert out["plan_fluence"] == [[1, 401, 201], 1000.0, 0.0]
    assert out["stages"] == ["pf.dispatch", "pf.fetch_unpack", "pf.h2d_stage",
                             "pf.host_orient", "pf.wmax_est"]
