"""The port runs with neither jax nor pydantic importable.

A child interpreter installs a meta-path finder that refuses ``jax``,
``jaxlib`` and ``pydantic``, imports ``pylinac_tpu_torch`` and
``pylinac_tpu_torch.ct``, makes a small AS500 picket fence with the port's
own image generator and analyses it on the CPU, finds the regions of a
small ring image with the CT region finder, analyses a small generated
Winston-Lutz set (four AS500 frames) with ``pylinac_tpu_torch.winston_lutz``
on the CPU, takes the 2D gamma of a 32x32 pair with
``pylinac_tpu_torch.ops.gamma``, and analyses a small AS500 open field
with ``FieldAnalysisBatch`` and ``FieldAnalysis`` on the CPU. The machine
with the card has neither package.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CHILD = textwrap.dedent("""
    import importlib.abc, json, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "pydantic")

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
    print(json.dumps({
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
