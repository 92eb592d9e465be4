#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pylinac_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and runs both halves of the main path:

- picket fence: checks the 3x3-median kernel bit for bit against its plain
  PyTorch twin, runs ``PicketFenceBatch`` on 64 EPID-like 1254x1254 uint16
  frames on the card, checks the results and holds them against the port's
  CPU run, then times the batch and the kernel;
- CatPhan 504: checks the connected-component kernel (label mode, 4- and
  8-connected, and hole-root mode) bit for bit against its twins on seeded
  masks at eight shapes, runs ``CatPhanBatch`` on four synthetic 60-slice
  512x512 scans on the card and the single-scan ``CatPhan504`` on one of
  them, holds the kernel against its twins on every mask those runs gave
  it, checks every scan against the bars of ``tests/models/test_ct.py``
  and the card against the CPU, then times the batch and the kernel.

The launch counts of each half are set to 0 just before it runs and read
just after. Every failure raises and exits non-zero. The last line of
standard output is one JSON object with ``"ok": true``; the line before it
lists each kernel with its launch count on the main path, its error against
the twin and both times.

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and
``nvidia-smi``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import multiprocessing
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

N_FRAMES = 64
N_FILES = 4
OFFSET_FILE = 1           # paths[1] has picket 3 moved by OFFSET_MM
OFFSET_MM = 0.4
MM_TOL = 0.01             # BASELINE.json parity bar
PCT_TOL = 0.1
KERNEL_SHAPES = [(N_FRAMES, 1254, 1254), (1, 1, 1), (1, 2, 3), (3, 37, 129), (1, 1280, 1280)]

CT_SCANS = 4              # the bench's CatPhan batch: 4 scans x 60 slices
CT_SLICES = 60
CT_SEED = 1234            # scan i has seed CT_SEED + i
ROLL_TOL = 0.01           # degrees
# the listed shapes, then the CatPhan path's: pooled localisation slices,
# roll slices and geometry-node crops of the batch and of a single scan
CCL_SHAPES = [(1, 1, 1), (1, 2, 3), (3, 37, 129), (1, 512, 512), (CT_SCANS * CT_SLICES, 256, 256),
              (CT_SCANS, 512, 512), (CT_SCANS, 140, 140), (1, 140, 140)]
CCL_KINDS = ("speckle 30%", "speckle 3%", "ring+noise", "spiral", "empty", "full")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_kernel(median) -> float:
    """The CUDA median must equal its twin bit for bit; returns the largest
    |kernel - twin| over all shapes (0.0 when they agree)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for shape in KERNEL_SHAPES:
        # integer-valued floats: many ties, as in uint16 frames
        x = torch.randint(0, 4096, shape, generator=gen, device="cuda").to(torch.float32)
        got = median.median3x3(x)
        want = median.median3x3_reference(x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise RuntimeError(f"median3x3 differs from its twin at {shape}: max |err| {err}")
        print(f"kernel check {shape}: bit-equal to twin")
    for bad, what in ((torch.zeros(4, 4, dtype=torch.float64, device="cuda"), "float64"),
                      (torch.zeros(4, 6, device="cuda")[:, ::2], "non-contiguous")):
        try:
            median.median3x3(bad)
        except (TypeError, ValueError) as e:
            print(f"kernel check {what}: raised {type(e).__name__}")
        else:
            raise RuntimeError(f"median3x3 accepted a {what} tensor")
    return worst


def make_frames(tmp: str):
    """Four AS1200 picket fence DICOMs (SID 1500, 10 pickets, 20 mm spacing,
    3 mm wide; picket 3 of one moved by 0.4 mm), loaded as 64 frames, each
    replaced by an unsaturated-EPID-like uint16 frame: raw x 0.5 + 1000
    counts dark offset, sigma-2 count noise, 0.01 % hot pixels at 65535."""
    from pylinac_tpu_torch import PicketFenceBatch
    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
    from pylinac_tpu_torch.imggen.simulators import AS1200Image
    from pylinac_tpu_torch.imggen.utils import generate_picketfence

    paths = []
    for i in range(N_FILES):
        err = [0.0] * 10
        if i == OFFSET_FILE:
            err[2] = OFFSET_MM
        path = f"{tmp}/pf{i}.dcm"
        generate_picketfence(
            simulator=AS1200Image(sid=1500), field_layer=PerfectFieldLayer, file_out=path,
            final_layers=[GaussianFilterLayer(sigma_mm=1)], pickets=10,
            picket_spacing_mm=20, picket_width_mm=3, gantry_angle=90 * i,
            picket_offset_error=err)
        paths.append(path)
    batch = PicketFenceBatch([paths[i % N_FILES] for i in range(N_FRAMES)], crop_mm=3)
    rng = np.random.default_rng(7)
    for im in batch.images:
        a = im.array
        noisy = a.astype(np.float64) * 0.5 + 1000 + rng.normal(0, 2, a.shape).round()
        noisy = np.clip(noisy, 0, 65535)
        noisy.flat[rng.choice(a.size, a.size // 10000, replace=False)] = 65535
        im.array = noisy.astype(np.uint16)
    return batch


def check_results(results, passes) -> None:
    if len(results) != N_FRAMES:
        raise RuntimeError(f"{len(results)} results for {N_FRAMES} frames")
    if min(passes) < 1:
        raise RuntimeError(f"the de-spike loop skipped frames: passes {passes}")
    for i, r in enumerate(results):
        if r.number_of_pickets != 10:
            raise RuntimeError(f"frame {i}: {r.number_of_pickets} pickets, want 10")
        if i % N_FILES != OFFSET_FILE and not (r.passed and r.max_error_mm < 0.1):
            raise RuntimeError(f"frame {i}: passed={r.passed} max error {r.max_error_mm} mm")
    perfect = results[0].offsets_from_cax_mm[2]
    shifts = [abs(r.offsets_from_cax_mm[2] - perfect)
              for i, r in enumerate(results) if i % N_FILES == OFFSET_FILE]
    if not all(abs(s - OFFSET_MM) <= 0.05 for s in shifts):
        raise RuntimeError(f"picket 3 shifts {shifts}, want {OFFSET_MM} +- 0.05 mm")
    print(f"slice check: {N_FRAMES} frames, 10 pickets each, de-spike passes "
          f"{sorted(set(passes))}, max error of perfect frames "
          f"{max(r.max_error_mm for i, r in enumerate(results) if i % N_FILES != OFFSET_FILE):.6f} mm, "
          f"picket 3 shift {min(shifts):.4f}-{max(shifts):.4f} mm")


def compare(card, cpu) -> float:
    """Card results against CPU results: integers, flags and leaf keys exact;
    mm within MM_TOL; percentages within PCT_TOL. Returns the largest mm
    difference."""
    def diff(a, b):
        return float(np.max(np.abs(np.subtract(a, b)))) if np.size(a) else 0.0

    mm_diffs = []
    for i, (g, c) in enumerate(zip(card, cpu)):
        for name in ("number_of_pickets", "max_error_picket", "max_error_leaf", "passed",
                     "failed_leaves", "cax"):
            if getattr(g, name) != getattr(c, name):
                raise RuntimeError(f"frame {i}: {name} {getattr(g, name)} != {getattr(c, name)}")
        if diff(g.percent_leaves_passing, c.percent_leaves_passing) > PCT_TOL:
            raise RuntimeError(f"frame {i}: percent passing differs")
        pairs = [(getattr(g, n), getattr(c, n), n) for n in (
            "absolute_median_error_mm", "max_error_mm", "mean_picket_spacing_mm",
            "mlc_skew", "offsets_from_cax_mm")]
        for name in ("mlc_positions_by_leaf", "mlc_errors_by_leaf", "picket_widths"):
            gd, cd = getattr(g, name), getattr(c, name)
            if list(gd) != list(cd):
                raise RuntimeError(f"frame {i}: {name} keys differ")
            for key in gd:
                if isinstance(gd[key], dict):
                    pairs.append((list(gd[key].values()), list(cd[key].values()), name))
                else:
                    pairs.append((gd[key], cd[key], name))
        for a, b, name in pairs:
            mm_diffs.append(diff(a, b))
            if mm_diffs[-1] > MM_TOL:
                raise RuntimeError(f"frame {i}: {name} differs by {mm_diffs[-1]} mm")
    return max(mm_diffs)


def ccl_mask(kind: str, shape: tuple[int, int, int], rng) -> np.ndarray:
    """A (B, H, W) bool batch of one kind: the masks of
    ``tests/ops/test_pallas_label.py:33-51`` drawn at any shape."""
    b, h, w = shape
    if kind == "speckle 30%":
        return rng.random(shape) > 0.7
    if kind == "speckle 3%":
        return rng.random(shape) > 0.97
    if kind == "empty":
        return np.zeros(shape, bool)
    if kind == "full":
        return np.ones(shape, bool)
    yy, xx = np.mgrid[:h, :w]
    if kind == "ring+noise":
        r = 0.4 * min(h, w)
        ring = np.abs(np.hypot(yy - h / 2, xx - w / 2) - r) < 1.5
        return ring[None] | (rng.random(shape) > 0.95)
    # a spiral of 3 turns: the worst case for sweep convergence
    scale = max(min(h, w), 1) / 64
    t = np.linspace(0, 6 * np.pi, int(4000 * max(scale, 1)))
    sr = 2 + t * 1.4 * scale
    sy = (h / 2 + sr * np.sin(t)).astype(int)
    sx = (w / 2 + sr * np.cos(t)).astype(int)
    keep = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    spiral = np.zeros((h, w), bool)
    spiral[sy[keep], sx[keep]] = True
    return np.broadcast_to(spiral, shape).copy()


def check_ccl(ccl) -> float:
    """The CCL kernel in label mode (4- and 8-connected) and hole-root mode
    must equal its twins bit for bit; returns the largest |kernel - twin|
    (0.0 when they agree)."""
    rng = np.random.default_rng(0)
    worst = 0
    for shape in CCL_SHAPES:
        for kind in CCL_KINDS:
            masks = torch.from_numpy(ccl_mask(kind, shape, rng)).cuda()
            for name, kernel, twin in (
                    ("label 4-conn", functools.partial(ccl.label_batch, connectivity=1),
                     functools.partial(ccl.label_reference, connectivity=1)),
                    ("label 8-conn", functools.partial(ccl.label_batch, connectivity=2),
                     functools.partial(ccl.label_reference, connectivity=2)),
                    ("holes", ccl.hole_roots_batch, ccl.hole_roots_reference)):
                got, want = kernel(masks), twin(masks)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                worst = max(worst, err)
                if not torch.equal(got, want):
                    raise RuntimeError(f"ccl {name} differs from its twin on {kind} at "
                                       f"{shape}: max |err| {err}")
        print(f"kernel check ccl {shape}: label 4/8-conn and holes bit-equal to twins "
              f"on {', '.join(CCL_KINDS)}")
    mask = torch.from_numpy(ccl_mask("ring+noise", (1, 512, 512), rng)[0]).cuda()
    if not (torch.equal(ccl.label(mask, 2), ccl.label_reference(mask[None], 2)[0])
            and torch.equal(ccl.hole_roots(mask), ccl.hole_roots_reference(mask[None])[0])):
        raise RuntimeError("ccl label/hole_roots at B = 1 differ from their twins")
    print("kernel check ccl (512, 512) single image: label and hole_roots bit-equal to twins")
    for bad, what in ((torch.zeros(1, 4, 4, device="cuda"), "float32"),
                      (torch.zeros(1, 4, 6, dtype=torch.bool, device="cuda")[:, :, ::2],
                       "non-contiguous")):
        for fn in (ccl.label_batch, ccl.hole_roots_batch):
            try:
                fn(bad)
            except (TypeError, ValueError) as e:
                print(f"kernel check ccl {fn.__name__} {what}: raised {type(e).__name__}")
            else:
                raise RuntimeError(f"{fn.__name__} accepted a {what} tensor")
    return float(worst)


@contextlib.contextmanager
def recording_ccl_inputs():
    """Within the block, record a copy of every mask that the region
    properties hand to the CCL kernel, as (mode, masks, extra arguments).
    The recorder wraps the entries that ``ops/label.py`` calls and passes
    each call through unchanged, so the launch counts stay the kernel's."""
    from pylinac_tpu_torch.ops import label as tlabel

    seen = []
    originals = tlabel.label_batch, tlabel.hole_roots_batch

    def recorder(mode, fn):
        def call(masks, *args):
            seen.append((mode, masks.clone(), args))
            return fn(masks, *args)
        return call

    tlabel.label_batch = recorder("label", originals[0])
    tlabel.hole_roots_batch = recorder("holes", originals[1])
    try:
        yield seen
    finally:
        tlabel.label_batch, tlabel.hole_roots_batch = originals


def check_path_masks(ccl, seen, what: str) -> None:
    """The CCL kernel must equal its twins bit for bit on every mask that a
    run of the path gave it."""
    shapes = []
    for mode, masks, args in seen:
        kernel, twin = ((ccl.label_batch, ccl.label_reference) if mode == "label"
                        else (ccl.hole_roots_batch, ccl.hole_roots_reference))
        got, want = kernel(masks, *args), twin(masks, *args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            raise RuntimeError(f"ccl {mode} differs from its twin on a {what} mask of shape "
                               f"{tuple(masks.shape)}: max |err| {err}")
        shapes.append(f"{mode} {tuple(masks.shape)}")
    print(f"kernel check ccl on the {what}'s {len(seen)} kernel inputs: bit-equal to twins "
          f"({', '.join(shapes)})")


def make_scans(tmp: str) -> list[str]:
    """Four synthetic CatPhan 504 scans (60 slices of 512x512 uint16, 2.5 mm
    slices, 0.5 mm pixels; seeds CT_SEED + i), written in parallel."""
    from pylinac_tpu_torch.imggen.ct import generate_catphan504

    dirs = [f"{tmp}/scan{i}" for i in range(CT_SCANS)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(CT_SCANS, mp_context=ctx) as pool:
        futures = [pool.submit(generate_catphan504, d, num_slices=CT_SLICES,
                               slice_thickness_mm=2.5, seed=CT_SEED + i)
                   for i, d in enumerate(dirs)]
        for f in futures:
            f.result()
    return dirs


def check_ct_results(results: list[dict], what: str) -> None:
    """``tests/models/test_ct.py:25-74``'s bars on every scan."""
    expected = {"Air": -1000, "PMP": -196, "LDPE": -104, "Poly": -47,
                "Acrylic": 115, "Delrin": 365, "Teflon": 1000}
    for i, r in enumerate(results):
        c404, c486 = r["ctp404"], r["ctp486"]
        checks = {
            "origin slice 30 +- 1": abs(r["origin_slice"] - 30) <= 1,
            "|roll| < 0.7 deg": abs(r["catphan_roll_deg"]) < 0.7,
            "HU plugs within 12 HU": all(abs(c404["hu_rois"][k]["value"] - v) < 12
                                         for k, v in expected.items()),
            "HU linearity passed": c404["hu_linearity_passed"],
            "node distance 50 +- 0.5 mm": abs(c404["avg_line_distance_mm"] - 50) < 0.5,
            "geometry passed": c404["geometry_passed"],
            "slice thickness 2.5 +- 0.6 mm": abs(c404["measured_slice_thickness_mm"] - 2.5) < 0.6,
            "uniformity passed": c486["passed"] and all(abs(x["value"]) < 10
                                                        for x in c486["rois"].values()),
            ">= 2 low-contrast ROIs seen": r["ctp515"]["num_rois_seen"] >= 2,
            "0.1 < mtf50 < 1.5": 0.1 < r["ctp528"]["mtf_lp_mm"]["50"] < 1.5,
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise RuntimeError(f"{what} scan {i} fails {failed}: {r}")
        print(f"{what} scan {i}: origin {r['origin_slice']}, roll "
              f"{r['catphan_roll_deg']:.4f} deg, nodes {c404['avg_line_distance_mm']:.4f} mm, "
              f"thickness {c404['measured_slice_thickness_mm']:.4f} mm, max HU error "
              f"{max(abs(c404['hu_rois'][k]['value'] - v) for k, v in expected.items()):.1f}, "
              f"ROIs seen {r['ctp515']['num_rois_seen']}, mtf50 "
              f"{r['ctp528']['mtf_lp_mm']['50']:.4f} lp/mm: inside every bar")


def compare_ct(a: dict, b: dict, what: str, path: str = "") -> float:
    """Two result dicts: keys, integers, booleans and strings exact; the roll
    within ROLL_TOL; other floats within MM_TOL or PCT_TOL %, whichever is
    larger. Returns the largest float difference."""
    if isinstance(a, dict):
        if list(a) != list(b):
            raise RuntimeError(f"{what}{path}: keys {list(a)} != {list(b)}")
        return max([compare_ct(a[k], b[k], what, f"{path}/{k}") for k in a
                    if k not in ("date_of_analysis", "pylinac_version")], default=0.0)
    if isinstance(a, list):
        if len(a) != len(b):
            raise RuntimeError(f"{what}{path}: lengths differ")
        return max([compare_ct(x, y, what, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b))],
                   default=0.0)
    if isinstance(a, float):
        tol = ROLL_TOL if path.endswith("catphan_roll_deg") else max(MM_TOL, PCT_TOL / 100 * abs(a))
        if not isinstance(b, float) or abs(a - b) > tol:
            raise RuntimeError(f"{what}{path}: {a} vs {b}")
        return abs(a - b)
    if a != b:
        raise RuntimeError(f"{what}{path}: {a!r} vs {b!r}")
    return 0.0


def time_pair(kernel, twin, x: torch.Tensor, n_kernel: int, n_twin: int) -> tuple[float, float]:
    """Mean ms per call of a kernel and of its twin, timed with CUDA events
    in turns (twin, kernel, kernel, twin)."""
    def run(fn, n):
        fn(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(x)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(run(twin if which == "plain" else kernel,
                                n_twin if which == "plain" else n_kernel))
    return statistics.mean(times["kernel"]), statistics.mean(times["plain"])


def build_all(names) -> None:
    """Build every kernel library at once, one ``nvcc`` each."""
    from pylinac_tpu_torch.ops import _build

    with ThreadPoolExecutor(len(names)) as pool:
        builds = dict(zip(names, pool.map(_build.build, names)))
    for name, (path, seconds, log) in builds.items():
        print(f"build {path.name}: {seconds:.2f} s" + ("" if seconds else " (already built)"))
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")


def picket_fence_phase(card: str, median) -> dict:
    """The picket fence half of the main path: kernel check, slice, card
    against CPU, timing. Returns the median kernel's line."""
    from pylinac_tpu_torch import PicketFenceBatch

    max_abs_err = check_kernel(median)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pf_")
    try:
        t0 = time.perf_counter()
        batch = make_frames(tmp)
        print(f"inputs: {N_FRAMES} frames {batch.images[0].shape} "
              f"{batch.images[0].array.dtype} in {time.perf_counter() - t0:.1f} s")
        median.median3x3.launches = 0
        batch.analyze(tolerance=0.5, device="cuda")
        results = batch.results_data()
        torch.cuda.synchronize()
        launches = median.median3x3.launches
        if launches < 1:
            raise RuntimeError("the picket fence path launched no median3x3 kernel")
        print(f"picket fence path: median3x3.launches = {launches}")
        check_results(results, batch._out["despike_passes"].tolist())

        cpu_batch = PicketFenceBatch(batch.images[:4])
        cpu_batch.analyze(tolerance=0.5, device="cpu")
        worst = compare(results[:4], cpu_batch.results_data())
        print(f"card vs CPU on frames 0-3: agree (max mm difference {worst:.2e})")

        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            batch.analyze(tolerance=0.5, device="cuda")
            batch.results_data()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        warm = statistics.median(times[1:])
        print(f"[{card}] warm analyze + results_data of {N_FRAMES} frames: "
              f"median {warm * 1e3:.1f} ms of 5 runs = {N_FRAMES / warm:.1f} frames/s "
              f"(runs ms: {', '.join(f'{t * 1e3:.1f}' for t in times[1:])})")

        frames = batch._stage_cache[1].to(torch.float32)
        kernel_ms, plain_ms = time_pair(median.median3x3, median.median3x3_reference,
                                        frames, 50, 5)
        print(f"[{card}] median3x3 at {tuple(frames.shape)}: kernel {kernel_ms:.4f} ms, "
              f"plain twin {plain_ms:.3f} ms")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"name": "median3x3", "route": "cuda",
            "source": "pylinac_tpu_torch/csrc/median3x3.cu",
            "replaces": "pylinac_tpu/ops/pallas_median.py:27",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms}


def catphan_phase(card: str, ccl) -> list[dict]:
    """The CatPhan half of the main path: kernel check, the 4-scan batch
    and the single scan on the card, card against CPU, timing. Returns the
    CCL kernel's two lines (label and holes modes)."""
    from pylinac_tpu_torch import ct

    max_abs_err = check_ccl(ccl)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ct_")
    try:
        t0 = time.perf_counter()
        dirs = make_scans(tmp)
        batch = ct.CatPhanBatch(dirs)
        print(f"inputs: {CT_SCANS} scans x {len(batch.cts[0].dicom_stack)} slices "
              f"{batch.cts[0].dicom_stack[0].array.shape} "
              f"{batch.cts[0].dicom_stack[0].array.dtype} in {time.perf_counter() - t0:.1f} s")

        ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
        with recording_ccl_inputs() as batch_inputs:
            batch.analyze(device="cuda")
            results = batch.results_data(as_dict=True)
        torch.cuda.synchronize()
        launches = {"label": ccl.label_batch.launches, "holes": ccl.hole_roots_batch.launches}
        if min(launches.values()) < 1:
            raise RuntimeError(f"the CatPhan batch path launched a CCL mode no time: {launches}")
        print(f"CatPhan batch path: label_batch.launches = {launches['label']}, "
              f"hole_roots_batch.launches = {launches['holes']}")
        check_ct_results(results, "card batch")

        single = ct.CatPhan504(dirs[0])
        ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
        with recording_ccl_inputs() as single_inputs:
            single.analyze(device="cuda")
            single_result = single.results_data(as_dict=True)
        torch.cuda.synchronize()
        single_launches = (ccl.label_batch.launches, ccl.hole_roots_batch.launches)
        # one launch of each mode localises the whole stack; the rest are
        # the B = 1 roll-slice and geometry-node searches
        if min(single_launches) < 3:
            raise RuntimeError(f"the single-scan path made no B = 1 launches: {single_launches}")
        print(f"CatPhan504 single-scan path: label launches {single_launches[0]}, holes "
              f"launches {single_launches[1]} (1 each for the stack, the rest at B = 1)")
        for what, seen, counts in (("batch run", batch_inputs, tuple(launches.values())),
                                   ("single-scan run", single_inputs, single_launches)):
            if (sum(m == "label" for m, _, _ in seen), sum(m == "holes" for m, _, _ in seen)) != counts:
                raise RuntimeError(f"the {what} recorded other kernel inputs than it launched")
            check_path_masks(ccl, seen, what)
        check_ct_results([single_result], "card single")
        worst = compare_ct(results[0], single_result, "card batch vs card single")
        print(f"card single scan vs card batch scan 0: agree (max difference {worst:.2e})")

        cpu = ct.CatPhan504(dirs[0])
        cpu.analyze(device="cpu")
        cpu_result = cpu.results_data(as_dict=True)
        worst = max(compare_ct(cpu_result, single_result, "CPU vs card single"),
                    compare_ct(cpu_result, results[0], "CPU vs card batch"))
        print(f"card vs CPU on scan 0: agree (max difference {worst:.2e}; roll "
              f"{single_result['catphan_roll_deg']:.6f} vs {cpu_result['catphan_roll_deg']:.6f} deg)")

        times = []
        for _ in range(6):
            for scan in batch.cts:
                scan._slice_centroids = None  # a fresh localisation per run
            t0 = time.perf_counter()
            batch.analyze(device="cuda")
            batch.results_data()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        warm = statistics.median(times[1:])
        n_slices = sum(len(scan.dicom_stack) for scan in batch.cts)
        print(f"[{card}] warm CatPhanBatch analyze + results_data of {CT_SCANS} scans: "
              f"median {warm * 1e3:.1f} ms of 5 runs = {CT_SCANS / warm:.3f} scans/s = "
              f"{n_slices / warm:.1f} slices/s "
              f"(runs ms: {', '.join(f'{t * 1e3:.1f}' for t in times[1:])})")

        # the batch's localisation masks, its largest kernel input: (240, 256, 256)
        masks = max((m for _, m, _ in batch_inputs), key=torch.Tensor.numel)
        lines = []
        for mode, kernel, twin in (
                ("label", functools.partial(ccl.label_batch, connectivity=2),
                 functools.partial(ccl.label_reference, connectivity=2)),
                ("holes", ccl.hole_roots_batch, ccl.hole_roots_reference)):
            kernel_ms, plain_ms = time_pair(kernel, twin, masks, 20, 3)
            print(f"[{card}] ccl {mode} at {tuple(masks.shape)} (the batch's localisation "
                  f"masks): kernel {kernel_ms:.4f} ms, plain twin {plain_ms:.3f} ms")
            lines.append({"name": f"ccl_{mode}", "route": "cuda",
                          "source": "pylinac_tpu_torch/csrc/ccl.cu",
                          "replaces": "pylinac_tpu/ops/pallas_label.py:336",
                          "launches": launches[mode], "max_abs_err": max_abs_err,
                          "ms": kernel_ms, "plain_ms": plain_ms})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


def main() -> int:
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from pylinac_tpu_torch.ops import ccl, median

    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    build_all([median.KERNEL, ccl.KERNEL])
    t0 = time.perf_counter()
    kernels = [picket_fence_phase(card, median)]
    print(f"picket fence phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += catphan_phase(card, ccl)
    print(f"CatPhan phase: {time.perf_counter() - t0:.1f} s; whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
