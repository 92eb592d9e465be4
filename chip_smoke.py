#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pylinac_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and runs the five ported paths:

- picket fence: checks the 3x3-median kernel bit for bit against its plain
  PyTorch twin (the path's shape and ragged ones), runs
  ``PicketFenceBatch`` on 64 EPID-like 1254x1254 uint16 frames on the card,
  checks the results and holds them against the port's CPU run, then
  times the batch and the kernel;
- CatPhan 504: checks the connected-component kernel (label mode, 4- and
  8-connected, and hole-root mode) bit for bit against its twins on eight
  seeded mask kinds (a checkerboard and a comb among them) at thirteen
  shapes (the tile edges and every path shape among them), with ten
  repeated launches equal, runs ``CatPhanBatch`` on four synthetic 60-slice
  512x512 scans on the card and the single-scan ``CatPhan504`` on one of
  them, holds the kernel against its twins on every mask those runs gave
  it, checks every scan against the bars of ``tests/models/test_ct.py``
  and the card against the CPU, shows the region sums order-fixed (ten
  more ``regionprops_batch`` calls on the batch's largest masks and ten
  ``radial_average`` calls on its NPS equal to the first, bit for bit; the
  exact sum candidates timed on the run's largest input), then times and
  profiles the batch (every warm run's results equal to the first's), and
  times the kernel in each mode at every input shape of the batch run (and
  each of its three passes);
- Winston-Lutz: checks the border-flood kernel (flood and filled-centroid
  entries) bit for bit against its twins on the same mask kinds and shapes
  plus the edges of its 128 x 128 px tiles, one frame (1, 1280, 1280) and
  the bench's (8, 1280, 1280), with ten repeated launches equal, writes
  the bench's 8-frame AS1200 session, runs ``WinstonLutz`` on the card in
  the default mode and under ``PYLINAC_TPU_FLOOD=packed`` and ``xla``, and
  the single-image ``WinstonLutz2D`` on frame 0, holds the CCL and flood
  kernels against their twins on every mask those runs gave them (the
  flood kernel ten more times each, equal), checks
  the results against the bars of ``tests/models/test_winstonlutz.py`` and
  the card against the CPU, repeats the region sums of the BB scan as for
  CatPhan, then times the batch (every warm run's results equal to the
  first's) and each kernel entry on
  the masks of the run that counted it, and prints the flood kernel's
  rounds and both entries' times on those masks and on a spiral;
- 2D gamma: checks the gamma kernel against its twin (NaN masks equal,
  every other value equal) at fifteen shapes and dta values (ragged widths,
  each side of the kernel's shared-memory limits), under
  global and local normalisation (NaN and +-inf inputs) with fill NaN and
  -1 and a cap that hides no candidate, runs the bench's 16 pairs of 768x1024 uint16 through
  ``gamma_2d_batch`` and pair 0 through ``gamma_2d`` on the card, holds the
  kernel against its twin on every input those runs gave it, checks the
  maps against a float32 numpy oracle (the bench's) and the CPU run, then
  times the batch with and without the fetch, profiles it, times its
  stages between CUDA events, and times the kernel against its twin on
  both of the run's inputs;
- FieldAnalysis: writes the bench's four AS1000 open fields, runs
  ``FieldAnalysisBatch`` on the 64 frames made of them on the card under
  the FWHM, inflection-derivative and Hill edges and the VARIAN, ELEKTA and
  SIEMENS protocols, each held to the CPU run of the four files, frames
  0-3 to a copy of the bench's numpy/scipy oracle and to the drawn field
  sizes; reruns the batch with ``filter=3`` (the median kernel counted,
  held bit-equal to its twin on the stack it was given, and timed there);
  holds the single-image ``FieldAnalysis`` (frame 0 through the filter, an
  asymmetric frame, an FFF frame under every edge) to the batch, and the
  full-frame ``field_analysis_batch`` to the strip route; then times each
  edge and the full-frame entry (every warm run's results equal to the
  first's), profiles the derivative and Hill batches and splits a
  derivative run's host time with cProfile.

The launch counts of each path are set to 0 just before it runs and read
just after. Every failure raises and exits non-zero. The last line of
standard output is one JSON object with ``"ok": true``; the line before it
lists each kernel with its launch count on its path, its error against the
twin, its time, the twin's, its bound (the least time for the bytes it must
move at 3.35 TB/s, or for its operations at the float32 rate, whichever is
larger; gamma and the median count float32 instructions at the issue rate)
and the time of one PyTorch call computing the same function where there
is one (none does for these kernels). The CatPhan phase profiles one
warm batch under ``torch.profiler`` (device busy time, idle share, kernels
and ops by device time). The WL phase ends by reporting where a warm batch
spends its time: the warm wall under each flood selector, the peak device
memory, one run under ``torch.profiler`` and one under cProfile.

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and
``nvidia-smi``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import cProfile
import functools
import io
import json
import multiprocessing
import pstats
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
# the path's shape, then ragged ones: W = 1, H = 1, W = 1, 2, 3 (mod 4),
# widths below one thread's 4 columns, odd pitches (no float2 loads), and
# heights around one thread's 16 rows and one block's 64
KERNEL_SHAPES = [(N_FRAMES, 1254, 1254), (1, 1, 1), (1, 2, 3), (3, 37, 129), (1, 1280, 1280),
                 (2, 1, 9), (2, 9, 1), (1, 70, 129), (1, 70, 130), (1, 70, 131), (2, 65, 3),
                 (2, 64, 2), (1, 17, 6)]

CT_SCANS = 4              # the bench's CatPhan batch: 4 scans x 60 slices
CT_SLICES = 60
CT_SEED = 1234            # scan i has seed CT_SEED + i
ROLL_TOL = 0.01           # degrees
# the listed shapes, the kernel's tile edges (32 columns x 32 rows), then the
# CatPhan path's pooled localisation slices, roll slices and geometry-node
# crops of the batch and of a single scan, and the WL BB scan's masks
CCL_SHAPES = [(1, 1, 1), (1, 2, 3), (3, 37, 129), (1, 512, 512),
              (1, 31, 33), (2, 33, 31), (2, 1000, 1), (2, 1, 1000),
              (CT_SCANS * CT_SLICES, 256, 256), (CT_SCANS, 512, 512), (CT_SCANS, 140, 140),
              (1, 140, 140), (416, 134, 134)]
CCL_KINDS = ("speckle 30%", "speckle 3%", "ring+noise", "spiral", "empty", "full", "checkerboard",
             "comb")
CCL_REPEATS = 10          # launches on one input that must give the same labels

WL_FRAMES = 8             # the bench's session: gantry 0/90/180/270 x collimator 0/90
PX_TOL = 1e-3             # selector and single-image centroids against the batch
# the listed shapes, the flood kernel's tile edges (128 rows x 128 columns),
# then the WL path's: one frame and the session
FLOOD_SHAPES = CCL_SHAPES + [(1, 127, 129), (2, 128, 128), (1, 129, 4097), (3, 257, 31),
                             (1, 1280, 1280), (WL_FRAMES, 1280, 1280)]

# the bench's Gamma2D (bench.py:727-731): 16 pairs of 768x1024 uint16, DTA 9
# px, 3 % global dose, cap 2, 5 % threshold
GAMMA_PAIRS, GAMMA_H, GAMMA_W = 16, 768, 1024
GAMMA_DTA, GAMMA_DOSE_TA, GAMMA_CAP, GAMMA_THRESH = 9, 3.0, 2.0, 5.0
GAMMA_ORACLE_TOL = 1e-3   # bench.py:797
GAMMA_CPU_TOL = 1e-6
# (shape, dta) of the kernel checks: the listed ones, the bench's, widths on
# every side of the kernel's 4 pixels a thread and 128 a block, and dta on
# each side of its shared-memory limits (23 | 24: the 48 KB a launch gets
# without opting in; 70 | 71: the H100's 227 KB opt-in, past which the
# kernel reads device memory)
GAMMA_CASES = [((1, 8, 8), 1), ((3, 40, 130), 3), ((3, 40, 130), 5), ((2, 97, 131), 9),
               ((1, 16, 16), 20), ((1, 24, 40), 47), ((GAMMA_PAIRS, GAMMA_H, GAMMA_W), 9),
               ((1, 1, 1), 1), ((2, 9, 129), 2), ((1, 13, 131), 9), ((1, 7, 257), 4),
               ((1, 20, 30), 23), ((1, 20, 30), 24), ((1, 6, 9), 70), ((1, 6, 9), 71)]
# (cap, threshold, fill); the cap of 40 hides no candidate, so that every
# offset of the disk can give the least value
GAMMA_SCALARS = [(2.0, 0.05, float("nan")), (2.0, 0.05, -1.0), (1.5, 0.3, float("nan")),
                 (40.0, 0.0, -1.0)]
REPEATS = 10              # region-sum calls on one input that must give the same bits

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the float32 rate
# outside the tensor cores, the rate charged to the integer operations of
# the CCL and flood kernels
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 instructions a second, for kernels whose every operation is its
# own instruction (gamma's unfused sub, mul, add and min; the median's
# min/max): 132 SMs x 4 schedulers x 32 lanes, one warp instruction a
# scheduler a clock, at the 1.98 GHz boost clock. 67 TFLOP/s is this rate
# counting a fused multiply-add as two operations.
F32_INSTR_PER_S = 132 * 128 * 1.98e9


def bound(bytes_moved: float, ops: float, rate: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least time in ms for a kernel that must move ``bytes_moved``
    (each input read once, each output written once) and do ``ops``
    operations at ``rate`` a second, and which of the two bounds it."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
        # integer-valued floats: many ties, as in uint16 frames; and int32
        # over its whole range, past where float32 is exact
        for x in (torch.randint(0, 4096, shape, generator=gen, device="cuda").to(torch.float32),
                  torch.randint(-2**31, 2**31, shape, generator=gen, device="cuda",
                                dtype=torch.int64).to(torch.int32)):
            got = median.median3x3(x)
            want = median.median3x3_reference(x)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want):
                raise RuntimeError(f"median3x3 differs from its twin at {shape} {x.dtype}: "
                                   f"max |err| {err}")
        print(f"kernel check {shape}: float32 and int32 bit-equal to twin")
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
    ``tests/ops/test_pallas_label.py:33-51`` drawn at any shape, a
    checkerboard (every diagonal an 8-connected edge) and a comb (vertical
    bars on the even columns joined only along the bottom row)."""
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
    if kind == "checkerboard":
        return np.broadcast_to((yy + xx) % 2 == 0, shape).copy()
    if kind == "comb":
        comb = xx % 2 == 0
        comb[-1, :] = True
        return np.broadcast_to(comb, shape).copy()
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
    must equal its twins bit for bit, and CCL_REPEATS more launches on the
    same input must give the same labels; returns the largest |kernel -
    twin| (0.0 when they agree)."""
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
                if not all(torch.equal(kernel(masks), got) for _ in range(CCL_REPEATS)):
                    raise RuntimeError(f"ccl {name} changed between launches on {kind} at {shape}")
        print(f"kernel check ccl {shape}: label 4/8-conn and holes bit-equal to twins "
              f"on {', '.join(CCL_KINDS)}; {CCL_REPEATS} repeated launches equal")
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


def ccl_entries() -> list[tuple]:
    """The names under which the region properties call the CCL kernel:
    (module, attribute, mode)."""
    from pylinac_tpu_torch.ops import label as tlabel

    return [(tlabel, "label_batch", "label"), (tlabel, "hole_roots_batch", "holes")]


def flood_entries() -> list[tuple]:
    """The names under which Winston-Lutz calls the flood kernel: the
    batched selectors call both batch entries by their names in
    ``winston_lutz.py``; ``fill_holes`` calls ``flood_from_border`` (B = 1)
    by its name in ``ops/label.py``."""
    from pylinac_tpu_torch import winston_lutz as twl
    from pylinac_tpu_torch.ops import label as tlabel

    return [(twl, "flood_from_border_batch", "flood"), (twl, "filled_centroid_batch", "centroid"),
            (tlabel, "flood_from_border", "flood")]


@contextlib.contextmanager
def recording_inputs(entries):
    """Within the block, record a copy of the first tensor handed to each
    entry ``(module, attribute, mode)`` as (mode, tensor, the other
    positional arguments, the keyword arguments). Each recorder passes the
    call through unchanged, so the launch counts stay the kernel's."""
    seen = []
    originals = [(module, name, getattr(module, name)) for module, name, _ in entries]

    def recorder(mode, fn):
        def call(masks, *args, **kwargs):
            seen.append((mode, masks.clone(), args, kwargs))
            return fn(masks, *args, **kwargs)
        return call

    for (module, name, fn), (_, _, mode) in zip(originals, entries):
        setattr(module, name, recorder(mode, fn))
    try:
        yield seen
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)


def kernel_pairs(ccl, flood=None) -> dict:
    """Each recorded mode's batch entry and its plain twin."""
    pairs = {"label": (ccl.label_batch, ccl.label_reference),
             "holes": (ccl.hole_roots_batch, ccl.hole_roots_reference)}
    if flood is not None:
        pairs["flood"] = flood.flood_from_border_batch, flood.flood_from_border_reference
        pairs["centroid"] = flood.filled_centroid_batch, flood.filled_centroid_reference
    return pairs


def check_counts(seen, counts: dict[str, int], what: str) -> None:
    """The recorded calls of each mode must equal its launch count."""
    recorded = {mode: sum(m == mode for m, *_ in seen) for mode in counts}
    if recorded != counts:
        raise RuntimeError(f"the {what} recorded {recorded} kernel inputs but launched {counts}")


def agree(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, float]:
    """Kernel output against twin output: ``torch.equal``, with NaN equal to
    NaN at the same place; and the largest |kernel - twin| where neither is
    NaN (0.0 when they agree)."""
    got64, want64 = got.to(torch.float64), want.to(torch.float64)
    nan = torch.isnan(got64)
    same = torch.equal(nan, torch.isnan(want64)) and torch.equal(got64[~nan], want64[~nan])
    diff = (got64 - want64).abs()[~(nan | torch.isnan(want64))]
    return same, float(diff.max()) if diff.numel() else 0.0


def check_path_masks(pairs: dict, seen, what: str, repeated=()) -> dict[str, float]:
    """Each kernel must equal its twin bit for bit on every input that a
    run of the path gave it, and the kernels of the ``repeated`` modes must
    give the same output in REPEATS more launches on each; returns the
    largest |kernel - twin| of each mode (0.0 where they agree)."""
    worst, shapes = {}, []
    for mode, masks, args, kwargs in seen:
        masks = masks if masks.dim() == 3 else masks[None]
        kernel, twin = pairs[mode]
        got, want = kernel(masks, *args, **kwargs), twin(masks, *args, **kwargs)
        torch.cuda.synchronize()
        same, err = agree(got, want)
        worst[mode] = max(worst.get(mode, 0.0), err)
        if not same:
            raise RuntimeError(f"{mode} differs from its twin on a {what} mask of shape "
                               f"{tuple(masks.shape)}: max |err| {err}")
        if mode in repeated and not all(torch.equal(kernel(masks, *args, **kwargs), got)
                                        for _ in range(REPEATS)):
            raise RuntimeError(f"{mode} changed between launches on a {what} mask of shape "
                               f"{tuple(masks.shape)}")
        shapes.append(f"{mode} {tuple(masks.shape)}")
    print(f"kernel check on the {what}'s {len(seen)} kernel inputs: bit-equal to twins, "
          f"max |err| {worst} ({', '.join(shapes)})"
          + (f"; {', '.join(repeated)} equal in {REPEATS} more launches" if repeated else ""))
    return worst


def region_entries() -> list[tuple]:
    """The names under which the paths call the region properties, their
    float sums and the NPS radial average: (module, attribute, mode)."""
    from pylinac_tpu_torch.metrics import batch_find
    from pylinac_tpu_torch.ops import label as tlabel
    from pylinac_tpu_torch.ops import stats as tstats

    return [(tlabel, "regionprops_batch", "regionprops"),
            (batch_find, "regionprops_batch", "regionprops"),
            (tlabel, "slot_sums", "slot_sums"), (tstats, "radial_average", "radial_average")]


def largest_record(seen, mode: str):
    """The recorded call of ``mode`` with the largest first tensor, as
    (tensor, positional arguments, keyword arguments), or None."""
    records = [(x, args, kwargs) for m, x, args, kwargs in seen if m == mode]
    return max(records, key=lambda r: r[0].numel()) if records else None


def results_text(result) -> str:
    """A typed result, or a list of them, as JSON without its
    ``date_of_analysis`` fields (nested ones too): the one field that a
    rerun must change."""
    def undated(x):
        if isinstance(x, dict):
            return {k: undated(v) for k, v in x.items() if k != "date_of_analysis"}
        return [undated(v) for v in x] if isinstance(x, list) else x

    if isinstance(result, list):
        return "\n".join(results_text(r) for r in result)
    return json.dumps(undated(json.loads(result.model_dump_json())))


def check_same_texts(texts: list[str], what: str) -> None:
    """Every warm run's results must equal the first's, character for
    character."""
    differ = [i for i, t in enumerate(texts) if t != texts[0]]
    if differ:
        a, b = texts[0], texts[differ[0]]
        at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        raise RuntimeError(f"{what}: warm runs {differ} give other results_data() than run 0; "
                           f"run {differ[0]} from character {at}: {b[max(at - 80, 0):at + 80]!r} "
                           f"against {a[max(at - 80, 0):at + 80]!r}")
    print(f"{what}: the results_data() of all {len(texts)} warm runs equal the first's, "
          f"character for character ({len(texts[0])} characters)")


def check_region_repeats(seen, what: str) -> None:
    """The card's region sums are order-fixed: REPEATS more calls of
    ``regionprops_batch`` on the largest input a path gave it, and of
    ``radial_average`` on the first NPS, must equal the first call's in
    every field, bit for bit."""
    from pylinac_tpu_torch.ops import label as tlabel
    from pylinac_tpu_torch.ops import stats as tstats

    masks, args, kwargs = largest_record(seen, "regionprops")
    first = tlabel.regionprops_batch(masks, *args, **kwargs)
    for _ in range(REPEATS):
        again = tlabel.regionprops_batch(masks, *args, **kwargs)
        differ = [name for name, a, b in zip(first._fields, first, again) if not torch.equal(a, b)]
        if differ:
            raise RuntimeError(f"{what}: regionprops_batch on {tuple(masks.shape)} changed "
                               f"between calls in {differ}")
    print(f"{what}: regionprops_batch on the recorded {tuple(masks.shape)} masks, "
          f"{kwargs}: {REPEATS} more calls equal to the first in all {len(first)} fields")
    nps = next((x for m, x, *_ in seen if m == "radial_average"), None)
    if nps is not None:
        first = tstats.radial_average(nps)
        if not all(torch.equal(tstats.radial_average(nps), first) for _ in range(REPEATS)):
            raise RuntimeError(f"{what}: radial_average on {tuple(nps.shape)} changed "
                               f"between calls")
        print(f"{what}: radial_average on the recorded {tuple(nps.shape)} NPS: {REPEATS} more "
              f"calls equal to the first")


def time_sum_candidates(card: str, seen, what: str) -> None:
    """The exact region-sum candidates on the largest recorded ``slot_sums``
    input: the float64 one-hot products the port keeps, the float32
    ``scatter_add_`` it replaced (atomics), and a stable sort by slot with
    ``segment_reduce``. Each is called REPEATS times (equal or not), held
    against the kept one and timed; the kept one must repeat bit for bit."""
    from pylinac_tpu_torch.ops import stats as tstats

    values, (slot, k), _ = largest_record(seen, "slot_sums")
    b, n, c = values.shape

    def atomics():
        index = slot.clamp(max=k)[..., None].expand(b, n, c)
        return torch.zeros(b, k + 1, c, device=values.device).scatter_add_(1, index, values)[:, :k]

    def sort_segment():
        clamped = slot.clamp(max=k)
        order = torch.sort(clamped, dim=1, stable=True).indices
        counts = torch.zeros(b, k + 1, dtype=torch.int64, device=values.device)
        counts.scatter_add_(1, clamped, torch.ones_like(clamped))
        return torch.segment_reduce(values.gather(1, order[..., None].expand(b, n, c)), "sum",
                                    lengths=counts, axis=1)[:, :k]

    kept = tstats._onehot_sums(values, slot, k)
    for name, fn in (("one-hot float64 bmm (kept)",
                      functools.partial(tstats._onehot_sums, values, slot, k)),
                     ("float32 scatter_add_, atomics (parent)", atomics),
                     ("stable sort + segment_reduce", sort_segment)):
        outs = [fn() for _ in range(REPEATS)]
        repeat = all(torch.equal(o, outs[0]) for o in outs)
        if name.endswith("(kept)") and not repeat:
            raise RuntimeError(f"{what}: the kept region sums changed between calls")
        diff = float((outs[0].double() - kept.double()).abs().max())
        ms = time_ms(lambda _: fn(), values, 10)
        print(f"[{card}] {what} region sums of {tuple(values.shape)} values into K = {k} slots: "
              f"{name} {ms:.4f} ms; {REPEATS} calls {'equal' if repeat else 'NOT equal'}; max "
              f"|diff| from the kept sums {diff:.3e}")


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


def ct_tol(path: str, a: float) -> float:
    """CatPhan's bars: the roll within ROLL_TOL, other floats within MM_TOL
    or PCT_TOL %, whichever is larger."""
    return ROLL_TOL if path.endswith("catphan_roll_deg") else max(MM_TOL, PCT_TOL / 100 * abs(a))


def wl_tol(path: str, a: float) -> float:
    """Winston-Lutz's bar: every float (mm, and px for the points) within
    MM_TOL."""
    return MM_TOL


def compare_tree(a, b, what: str, tol, path: str = "") -> float:
    """Two result dicts: keys, integers, booleans and strings exact; each
    float within ``tol(path, value)``. Returns the largest float
    difference."""
    if isinstance(a, dict):
        if list(a) != list(b):
            raise RuntimeError(f"{what}{path}: keys {list(a)} != {list(b)}")
        return max([compare_tree(a[k], b[k], what, tol, f"{path}/{k}") for k in a
                    if k not in ("date_of_analysis", "pylinac_version")], default=0.0)
    if isinstance(a, list):
        if len(a) != len(b):
            raise RuntimeError(f"{what}{path}: lengths differ")
        return max([compare_tree(x, y, what, tol, f"{path}[{i}]")
                    for i, (x, y) in enumerate(zip(a, b))], default=0.0)
    if isinstance(a, float):
        if not isinstance(b, float) or abs(a - b) > tol(path, a):
            raise RuntimeError(f"{what}{path}: {a} vs {b}")
        return abs(a - b)
    if a != b:
        raise RuntimeError(f"{what}{path}: {a!r} vs {b!r}")
    return 0.0


def ccl_bound(masks: torch.Tensor) -> tuple[float, str]:
    """CCL: one mask byte in and one int32 label out per pixel; about ten
    integer operations per pixel for the union of its two or four edges."""
    return bound(5 * masks.numel(), 10 * masks.numel())


def time_ms(fn, x: torch.Tensor, n: int) -> float:
    """Mean ms per call of ``fn(x)`` over n calls after one warm-up, timed
    with CUDA events."""
    fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_pair(kernel, twin, x: torch.Tensor, n_kernel: int, n_twin: int) -> tuple[float, float]:
    """Mean ms per call of a kernel and of its twin, timed in turns (twin,
    kernel, kernel, twin)."""
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(time_ms(twin if which == "plain" else kernel, x,
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
        # float32 in and out; per output 21 min/max instructions: 6 window
        # columns sorted (6 each) for 4 outputs, then 12 (csrc/median3x3.cu)
        bound_ms, bound_by = bound(8 * frames.numel(), 21 * frames.numel(), F32_INSTR_PER_S)
        print(f"[{card}] median3x3 at {tuple(frames.shape)}: kernel {kernel_ms:.4f} ms, "
              f"plain twin {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"name": "median3x3", "route": "cuda",
            "source": "pylinac_tpu_torch/csrc/median3x3.cu",
            "replaces": "pylinac_tpu/ops/pallas_median.py:27",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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
        with recording_inputs(ccl_entries()) as batch_inputs, \
                recording_inputs(region_entries()) as region_inputs:
            batch.analyze(device="cuda")
            results = batch.results_data(as_dict=True)
        torch.cuda.synchronize()
        launches = {"label": ccl.label_batch.launches, "holes": ccl.hole_roots_batch.launches}
        if min(launches.values()) < 1:
            raise RuntimeError(f"the CatPhan batch path launched a CCL mode no time: {launches}")
        print(f"CatPhan batch path: label_batch.launches = {launches['label']}, "
              f"hole_roots_batch.launches = {launches['holes']}")
        check_ct_results(results, "card batch")
        check_region_repeats(region_inputs, "CatPhan batch run")
        time_sum_candidates(card, region_inputs, "CatPhan batch run")

        single = ct.CatPhan504(dirs[0])
        ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
        with recording_inputs(ccl_entries()) as single_inputs:
            single.analyze(device="cuda")
            single_result = single.results_data(as_dict=True)
        torch.cuda.synchronize()
        single_launches = {"label": ccl.label_batch.launches,
                           "holes": ccl.hole_roots_batch.launches}
        # one launch of each mode localises the whole stack; the rest are
        # the B = 1 roll-slice and geometry-node searches
        if min(single_launches.values()) < 3:
            raise RuntimeError(f"the single-scan path made no B = 1 launches: {single_launches}")
        print(f"CatPhan504 single-scan path: label launches {single_launches['label']}, holes "
              f"launches {single_launches['holes']} (1 each for the stack, the rest at B = 1)")
        for what, seen, counts in (("batch run", batch_inputs, launches),
                                   ("single-scan run", single_inputs, single_launches)):
            check_counts(seen, counts, what)
            max_abs_err = max([max_abs_err,
                               *check_path_masks(kernel_pairs(ccl), seen, what).values()])
        check_ct_results([single_result], "card single")
        worst = compare_tree(results[0], single_result, "card batch vs card single", ct_tol)
        print(f"card single scan vs card batch scan 0: agree (max difference {worst:.2e})")

        cpu = ct.CatPhan504(dirs[0])
        cpu.analyze(device="cpu")
        cpu_result = cpu.results_data(as_dict=True)
        worst = max(compare_tree(cpu_result, single_result, "CPU vs card single", ct_tol),
                    compare_tree(cpu_result, results[0], "CPU vs card batch", ct_tol))
        print(f"card vs CPU on scan 0: agree (max difference {worst:.2e}; roll "
              f"{single_result['catphan_roll_deg']:.6f} vs {cpu_result['catphan_roll_deg']:.6f} deg)")

        def warm_batch():
            for scan in batch.cts:
                scan._slice_centroids = None  # a fresh localisation per run
            batch.analyze(device="cuda")
            data = batch.results_data()
            torch.cuda.synchronize()
            return data

        times, texts = [], []
        for _ in range(6):
            t0 = time.perf_counter()
            data = warm_batch()
            times.append(time.perf_counter() - t0)
            texts.append(results_text(data))
        check_same_texts(texts, "CatPhan warm batches")
        warm = statistics.median(times[1:])
        n_slices = sum(len(scan.dicom_stack) for scan in batch.cts)
        print(f"[{card}] warm CatPhanBatch analyze + results_data of {CT_SCANS} scans: "
              f"median {warm * 1e3:.1f} ms of 5 runs = {CT_SCANS / warm:.3f} scans/s = "
              f"{n_slices / warm:.1f} slices/s "
              f"(runs ms: {', '.join(f'{t * 1e3:.1f}' for t in times[1:])})")
        device_profile(card, "CatPhan", warm_batch, warm * 1e3)

        # every distinct input of the batch run in each mode: the pooled
        # localisation slices (240, 256, 256), the roll slices (4, 512, 512)
        # and the geometry-node crops (4, 140, 140); the kernels line takes
        # the largest
        inputs = {}
        for mode, m, args, kwargs in batch_inputs:
            key = (mode, tuple(m.shape))
            inputs[key] = (m, args, kwargs, inputs.get(key, (None, None, None, 0))[3] + 1)
        pairs, lines = kernel_pairs(ccl), []
        for (mode, shape), (m, args, kwargs, n) in inputs.items():
            kernel, twin = pairs[mode]
            timed = timed_pair(card, f"ccl {mode} ({n} of the batch run's {launches[mode]} "
                               f"launches)", lambda x: kernel(x, *args, **kwargs),
                               lambda x: twin(x, *args, **kwargs), m, ccl_bound)
            print_ccl_parts(card, ccl, mode, m, args, kwargs)
            if shape == max((s for md, s in inputs if md == mode), key=np.prod):
                lines.append(ccl_line(f"ccl_{mode}", "pylinac_tpu/ops/pallas_label.py:336",
                                      launches[mode], max_abs_err, timed))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


def print_ccl_parts(card: str, ccl, mode: str, masks: torch.Tensor, args, kwargs) -> None:
    """Where the CCL kernel's time goes on one recorded input: the device
    time of each of its three passes, under ``torch.profiler`` over 10
    launches."""
    from torch.autograd import DeviceType

    connectivity = (args or (kwargs.get("connectivity", 1),))[0] if mode == "label" else 1
    code, counter = ((ccl._LABEL, ccl.label_batch) if mode == "label"
                     else (ccl._HOLES, ccl.hole_roots_batch))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ccl._launch(masks, code, connectivity, counter)
        torch.cuda.synchronize()
    parts = {name: sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and f"{name}_kernel" in e.key) / 10e3
             for name in ("local", "border", "resolve")}
    print(f"[{card}] ccl {mode} at {tuple(masks.shape)} by pass (torch.profiler, mean of 10): "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in parts.items()))


def flood_bound(masks: torch.Tensor, entry: str) -> tuple[float, str]:
    """Border flood: one mask byte in per pixel and, for the flood entry, one
    int32 out (the centroid entry writes 8 bytes per image); about ten
    operations per 32-pixel word and pass."""
    out = 4 * masks.numel() if entry == "flood" else 8 * masks.shape[0]
    return bound(masks.numel() + out, masks.numel())


def check_flood(flood) -> float:
    """Both flood entries must equal their twins bit for bit on the CCL
    mask kinds at every shape, and give the same output in CCL_REPEATS more
    launches (the kernel's blocks race on their halos); returns the largest
    |kernel - twin| (0.0 when they agree)."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for shape in FLOOD_SHAPES:
        for kind in CCL_KINDS:
            masks = torch.from_numpy(ccl_mask(kind, shape, rng)).cuda()
            for name, kernel, twin in (
                    ("flood", flood.flood_from_border_batch, flood.flood_from_border_reference),
                    ("filled centroid", flood.filled_centroid_batch,
                     flood.filled_centroid_reference)):
                got, want = kernel(masks), twin(masks)
                torch.cuda.synchronize()
                err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
                worst = max(worst, err)
                if not torch.equal(got, want):
                    raise RuntimeError(f"{name} differs from its twin on {kind} at {shape}: "
                                       f"max |err| {err}")
                if not all(torch.equal(kernel(masks), got) for _ in range(CCL_REPEATS)):
                    raise RuntimeError(f"{name} changed between launches on {kind} at {shape}")
        print(f"kernel check flood {shape}: flood and filled centroid bit-equal to twins "
              f"on {', '.join(CCL_KINDS)}; {CCL_REPEATS} repeated launches equal")
    for bad, what in ((torch.zeros(1, 4, 4, device="cuda"), "float32"),
                      (torch.zeros(1, 4, 6, dtype=torch.bool, device="cuda")[:, :, ::2],
                       "non-contiguous")):
        for fn in (flood.flood_from_border_batch, flood.filled_centroid_batch):
            try:
                fn(bad)
            except (TypeError, ValueError) as e:
                print(f"kernel check {fn.__name__} {what}: raised {type(e).__name__}")
            else:
                raise RuntimeError(f"{fn.__name__} accepted a {what} tensor")
    return worst


def check_wl_results(data: dict, what: str) -> None:
    """``tests/models/test_winstonlutz.py``'s bars for the generated offset:
    the shift is RIGHT 0.5 and DOWN 0.3 mm (``test_offset_bb_left``,
    ``test_offset_bb_up_and_in``) and the gantry isocentre is tight
    (``test_perfect_wl``)."""
    sv = data["bb_shift_vector"]
    checks = {
        "8 images": data["num_total_images"] == WL_FRAMES,
        "shift x 0.5 +- 0.3 mm": abs(sv["x"] - 0.5) < 0.3,
        "shift y 0 +- 0.3 mm": abs(sv["y"]) < 0.3,
        "shift z -0.3 +- 0.3 mm": abs(sv["z"] + 0.3) < 0.3,
        "gantry iso diameter < 0.3 mm": data["gantry_3d_iso_diameter_mm"] < 0.3,
        "all values finite": all(np.isfinite(v) for v in data.values() if isinstance(v, float)),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{what} fails {failed}: {data}")
    print(f"{what}: shift ({sv['x']:.4f}, {sv['y']:.4f}, {sv['z']:.4f}) mm, max 2D CAX-BB "
          f"{data['max_2d_cax_to_bb_mm']:.4f} mm, gantry iso "
          f"{data['gantry_3d_iso_diameter_mm']:.6f} mm: inside every bar")


def centres(data: dict) -> np.ndarray:
    """(field x, field y, BB x, BB y) in px of each image of a result."""
    details = data["image_details"] if "image_details" in data else [data]
    return np.array([[d["field_cax"]["x"], d["field_cax"]["y"],
                      d["bb_location"]["x"], d["bb_location"]["y"]] for d in details])


def write_session(d: str) -> str:
    """Write the bench's 8-frame session into ``d`` (AS1200 at SID 1000, a
    30 mm field, a 5 mm BB 0.5 mm left and 0.3 mm up, gantry 0/90/180/270 x
    collimator 0/90, 1 mm blur); returns ``d``."""
    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
    from pylinac_tpu_torch.imggen.simulators import AS1200Image
    from pylinac_tpu_torch.imggen.utils import generate_winstonlutz

    generate_winstonlutz(
        simulator=AS1200Image(sid=1000), field_layer=PerfectFieldLayer,
        final_layers=[GaussianFilterLayer(sigma_mm=1)], dir_out=d,
        image_axes=[(g, c, 0) for g in (0, 90, 180, 270) for c in (0, 90)],
        offset_mm_left=0.5, offset_mm_up=0.3)
    return d


def warm_run(wl, texts: list | None = None) -> float:
    """One analyze + results_data on the card from a fresh BB scan, the
    frames staged (as ``bench.py:446-449``); returns its wall in ms and
    appends the results' text (:func:`results_text`) to ``texts``."""
    wl._bb_scan_cache = None
    for img in wl.images:
        img._precomputed_bb_points = None
        img._precomputed_field_centroid = None
    t0 = time.perf_counter()
    wl.analyze(device="cuda")
    data = wl.results_data()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if texts is not None:
        texts.append(results_text(data))
    return wall


def device_profile(card: str, what: str, run, default_ms: float, top: int = 20) -> None:
    """One ``run()`` under ``torch.profiler``: the device's busy time (the
    sum of the device kernels' self time) and its idle share against the
    profiled wall and against ``default_ms``, the unprofiled median; the
    device kernels by self time and the host ops by the device time of the
    kernels they launched."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    tables = {"kernel": {}, "op": {}}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            kind = "kernel" if e.device_type == DeviceType.CUDA else "op"
            tables[kind][e.key] = (e.self_device_time_total / 1e3, e.count)
    busy = sum(ms for ms, _ in tables["kernel"].values())
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    n_kernels = sum(n for _, n in tables["kernel"].values())
    print(f"[{card}] {what} profile: {n_kernels} kernel launches, "
          f"profiled run wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {100 * (1 - busy / wall):.1f} % of the profiled wall and "
          f"{100 * (1 - busy / default_ms):.1f} % of the unprofiled median {default_ms:.3f} ms")
    for kind, rows in tables.items():
        for key, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"  {kind:6s} {ms:9.3f} ms  {n:5d} x  {key[:100]}")


def profile_wl(card: str, wl, default_ms: float, top: int = 20) -> None:
    """Where a warm WL batch spends its time: the warm wall under the two
    exact selectors (median of 5 after 1 warm-up; the default's is
    ``default_ms``), the peak device memory of a run, one run under
    ``torch.profiler`` (:func:`device_profile`) and one run under cProfile
    (the host functions by cumulative time)."""
    from pylinac_tpu_torch.winston_lutz import flood_selector

    for mode in ("packed", "xla"):
        with flood_selector(mode):
            runs = [warm_run(wl) for _ in range(6)][1:]
        print(f"[{card}] profile: PYLINAC_TPU_FLOOD={mode}: warm analyze + results_data median "
              f"{statistics.median(runs):.3f} ms (runs ms: {', '.join(f'{t:.3f}' for t in runs)})")
    with flood_selector(""):
        torch.cuda.reset_peak_memory_stats()
        warm_run(wl)
        print(f"[{card}] profile: peak device memory of a run "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        device_profile(card, "WL", lambda: warm_run(wl), default_ms, top)

        pr = cProfile.Profile()
        pr.enable()
        wall = warm_run(wl)
        pr.disable()
        out = io.StringIO()
        pstats.Stats(pr, stream=out).sort_stats("cumulative").print_stats(top * 2)
        print(f"[{card}] profile: cProfile run wall {wall:.3f} ms")
        print(out.getvalue())


def ccl_line(name: str, replaces: str, launches: int, err: float, timed) -> dict:
    """A kernels-line entry of ``csrc/ccl.cu``; ``timed`` is (ms, plain ms,
    bound ms, bound by)."""
    ms, plain_ms, bound_ms, bound_by = timed
    return {"name": name, "route": "cuda", "source": "pylinac_tpu_torch/csrc/ccl.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def timed_pair(card: str, what: str, kernel, twin, x: torch.Tensor, bound_) -> tuple:
    """Times a kernel against its twin on ``x`` and prints the line; returns
    (ms, plain ms, bound ms, bound by)."""
    kernel_ms, plain_ms = time_pair(kernel, twin, x, 20, 3)
    bound_ms, bound_by = bound_(x)
    print(f"[{card}] {what} at {tuple(x.shape)}: kernel {kernel_ms:.4f} ms, plain twin "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return kernel_ms, plain_ms, bound_ms, bound_by


def winston_lutz_phase(card: str, ccl, flood) -> list[dict]:
    """The Winston-Lutz path: flood kernel check, the 8-frame batch on the
    card (default, packed and xla selectors), the single image, every mask
    those runs handed the CCL and flood kernels, card against CPU, timing,
    and where the time goes. Returns the kernels-line
    entries of each counted run: the CCL kernel's 4-connected modes on the
    batch's BB scan and on the single image's window, the flood entry on
    the ``xla`` batch and on the single image, and the centroid entry on the
    ``packed`` batch."""
    from pylinac_tpu_torch import WinstonLutz, WinstonLutz2D
    from pylinac_tpu_torch.winston_lutz import flood_selector

    synth_err = check_flood(flood)
    pairs = kernel_pairs(ccl, flood)
    counters = {"label": ccl.label_batch, "holes": ccl.hole_roots_batch,
                "flood": flood.flood_from_border_batch, "centroid": flood.filled_centroid_batch}

    def counted_run(run, what: str):
        """``run()`` with every launch count at 0 and every kernel input
        recorded; checks the records against the counts and the kernels
        against their twins on them. Returns (its result, its counts, its
        recorded masks, the largest error of each mode)."""
        for counter in counters.values():
            counter.launches = 0
        with recording_inputs(ccl_entries() + flood_entries()) as seen:
            out = run()
        torch.cuda.synchronize()
        counts = {mode: counter.launches for mode, counter in counters.items()}
        check_counts(seen, counts, what)
        return out, counts, seen, check_path_masks(pairs, seen, what, ("flood", "centroid"))

    def analyze(wl, mode: str):
        def run():
            with flood_selector(mode):
                wl.analyze(device="cuda")
                return wl.results_data(as_dict=True)
        return run

    tmp = tempfile.mkdtemp(prefix="chip_smoke_wl_")
    try:
        t0 = time.perf_counter()
        session = write_session(f"{tmp}/wl")
        batch = WinstonLutz(session)
        print(f"inputs: {len(batch.images)} WL frames {batch.images[0].shape} "
              f"{batch.images[0].array.dtype} in {time.perf_counter() - t0:.1f} s")

        with recording_inputs(region_entries()) as region_inputs:
            results, launches, batch_inputs, batch_err = counted_run(
                analyze(batch, ""), "WL batch run")
        if min(launches["label"], launches["holes"]) < 1:
            raise RuntimeError(f"the WL batch path launched a CCL mode no time: {launches}")
        print(f"WL batch path: launches {launches}")
        check_wl_results(results, "card batch")
        check_region_repeats(region_inputs, "WL batch run")
        time_sum_candidates(card, region_inputs, "WL batch run")

        cpu = WinstonLutz(session)
        with flood_selector(""):
            cpu.analyze(device="cpu")
        worst = compare_tree(cpu.results_data(as_dict=True), results, "CPU vs card batch",
                             wl_tol)
        print(f"card vs CPU batch: agree (max difference {worst:.2e})")

        selector_runs = {}
        for mode, entry in (("packed", "centroid"), ("xla", "flood")):
            data, counts, seen, err = counted_run(
                analyze(WinstonLutz(session), mode), f"WL batch run under the {mode} selector")
            selector_runs[mode] = counts, seen, err
            if counts[entry] < 1:
                raise RuntimeError(f"PYLINAC_TPU_FLOOD={mode} launched no "
                                   f"{counters[entry].__name__}")
            diff = float(np.abs(centres(data)[:, :2] - centres(results)[:, :2]).max())
            if diff > PX_TOL:
                raise RuntimeError(f"{mode} field centres differ from the default by {diff} px")
            check_wl_results(data, f"card batch, {mode} selector")
            print(f"WL batch, PYLINAC_TPU_FLOOD={mode}: launches {counts}, field centres "
                  f"within {diff:.2e} px of the default")

        single = WinstonLutz2D(str(batch.images[0].path))
        single_data, single_launches, single_inputs, single_err = counted_run(
            analyze(single, ""), "WL single-image run")
        if min(single_launches["flood"], single_launches["label"],
               single_launches["holes"]) < 1:
            raise RuntimeError(f"the single image launched a kernel no time: {single_launches}")
        diff = float(np.abs(centres(single_data) - centres(results)[:1]).max())
        if diff > PX_TOL:
            raise RuntimeError(f"the single image differs from batch image 0 by {diff} px")
        print(f"WinstonLutz2D on frame 0: launches {single_launches}; within {diff:.2e} px of "
              f"the batch")

        texts = []
        with flood_selector(""):  # a fresh BB scan per run, as bench.py:446-449
            times = [warm_run(batch, texts) for _ in range(6)]
        check_same_texts(texts, "WL warm runs")
        warm = statistics.median(times[1:])
        print(f"[{card}] warm WinstonLutz analyze + results_data of {WL_FRAMES} frames: "
              f"median {warm:.1f} ms of 5 runs = {WL_FRAMES / warm * 1e3:.2f} images/s "
              f"(runs ms: {', '.join(f'{t:.1f}' for t in times[1:])})")

        def largest(seen, mode: str) -> torch.Tensor:
            masks = max((m for m_, m, *_ in seen if m_ == mode), key=torch.Tensor.numel)
            return masks if masks.dim() == 3 else masks[None]

        label4 = (functools.partial(ccl.label_batch, connectivity=1),
                  functools.partial(ccl.label_reference, connectivity=1))
        lines = []
        for name, entry, (counts, seen, err), replaces, where in (
                ("flood_from_border", "flood", selector_runs["xla"],
                 "pylinac_tpu/ops/pallas_label.py:165", "the xla batch's field masks"),
                ("filled_centroid", "centroid", selector_runs["packed"],
                 "pylinac_tpu/ops/pallas_label.py:510", "the packed batch's field masks"),
                ("flood_from_border_single", "flood", (single_launches, single_inputs, single_err),
                 "pylinac_tpu/ops/pallas_label.py:165", "the single image's mask")):
            masks = largest(seen, entry)
            ms, plain_ms, bound_ms, bound_by = timed_pair(
                card, f"{name} on {where}", *pairs[entry], masks,
                functools.partial(flood_bound, entry=entry))
            lines.append({"name": name, "route": "cuda",
                          "source": "pylinac_tpu_torch/csrc/flood.cu", "replaces": replaces,
                          "launches": counts[entry], "max_abs_err": max(synth_err, err[entry]),
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "library_ms": None})
        spiral = torch.from_numpy(ccl_mask("spiral", (1, 1280, 1280),
                                           np.random.default_rng(0))).cuda()
        for where, masks in (
                ("the xla batch's field masks", largest(selector_runs["xla"][1], "flood")),
                ("the packed batch's field masks", largest(selector_runs["packed"][1], "centroid")),
                ("the single image's mask", largest(single_inputs, "flood")),
                ("a 3-turn spiral", spiral)):
            out, rounds = flood.flood_rounds(masks)
            if not torch.equal(out, flood.flood_from_border_reference(masks)):
                raise RuntimeError(f"flood_rounds differs from the twin on {where}")
            print(f"[{card}] flood kernel on {where} {tuple(masks.shape)}: {rounds} rounds; "
                  f"flood entry {time_ms(flood.flood_from_border_batch, masks, 20):.4f} ms, "
                  f"centroid entry {time_ms(flood.filled_centroid_batch, masks, 20):.4f} ms")
        field_masks = largest(selector_runs["xla"][1], "flood")
        holes_ms = time_ms(ccl.hole_roots_batch, field_masks, 20)
        print(f"[{card}] ccl holes on the same field masks: {holes_ms:.4f} ms")

        for mode, kernel_twin in (("label", label4),
                                  ("holes", (ccl.hole_roots_batch, ccl.hole_roots_reference))):
            masks = largest(batch_inputs, mode)
            lines.append(ccl_line(
                f"ccl_{mode}_bb_scan", "pylinac_tpu/ops/pallas_label.py:336", launches[mode],
                batch_err[mode], timed_pair(card, f"ccl {mode} 4-conn on the BB scan's masks",
                                            *kernel_twin, masks, ccl_bound)))
            print_ccl_parts(card, ccl, mode, masks, (1,) if mode == "label" else (), {})
        # the single image's B = 1 window: the TPU's single-image kernels #2, #5
        for mode, kernel_twin, replaces in (
                ("label", label4, "pylinac_tpu/ops/pallas_label.py:69"),
                ("holes", (ccl.hole_roots_batch, ccl.hole_roots_reference),
                 "pylinac_tpu/ops/pallas_label.py:232")):
            lines.append(ccl_line(
                f"ccl_{mode}_single", replaces, single_launches[mode], single_err[mode],
                timed_pair(card, f"ccl {mode} 4-conn on the single image's window",
                           *kernel_twin, largest(single_inputs, mode), ccl_bound)))
        profile_wl(card, batch, warm)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


def gamma_inputs(shape: tuple[int, int, int], dta: int, local: bool,
                 gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """A (ref_n, eval_p) pair on the card, normalised as ``gamma_2d`` does:
    doses over [0, 100) with 1 % NaN in the reference and in the evaluation,
    1 % negative evaluations, 1 % negative and 2 % zero references, divided
    by 3 % of the finite reference maximum (``local``: of each reference
    pixel, so that a zero reference gives a NaN ``ref_n`` and +-inf in
    ``eval_p``), the evaluation edge-padded by ``dta``. Globally normalised
    values lie on both sides of the thresholds 0.05 and 0.3."""
    def uniform():
        return torch.rand(shape, generator=gen, device=gen.device)

    ref = uniform() * 100
    ev = ref + (uniform() - 0.5) * 4
    u, v = uniform(), uniform()
    ref = torch.where(u < 0.01, torch.nan, torch.where(u < 0.02, -ref, ref))
    ref = torch.where((u >= 0.02) & (u < 0.04), 0.0, ref)
    ev = torch.where(v < 0.01, torch.nan, torch.where(v < 0.02, -ev, ev))
    dose_ta = 0.03 * (ref if local else torch.nan_to_num(ref).amax())
    eval_p = torch.nn.functional.pad((ev / dose_ta)[:, None], (dta,) * 4, mode="replicate")[:, 0]
    return (ref / dose_ta).contiguous(), eval_p.contiguous()


def check_gamma(gamma2d) -> float:
    """The gamma kernel must equal its twin (NaN masks equal, every other
    value equal) at every shape and dta of GAMMA_CASES, under global
    and local normalisation, with each (cap, threshold, fill) of
    GAMMA_SCALARS; returns the largest |kernel - twin| (0.0 when they
    agree)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for shape, dta in GAMMA_CASES:
        for local in (False, True):
            ref_n, eval_p = gamma_inputs(shape, dta, local, gen)
            for cap, threshold_n, fill in GAMMA_SCALARS:
                got = gamma2d.gamma2d(ref_n, eval_p, dta, cap, threshold_n, fill)
                want = gamma2d.gamma2d_reference(ref_n, eval_p, dta, cap, threshold_n, fill)
                torch.cuda.synchronize()
                same, err = agree(got, want)
                worst = max(worst, err)
                if not same:
                    raise RuntimeError(f"gamma2d differs from its twin at {shape} dta {dta} "
                                       f"(local {local}, cap {cap}, threshold {threshold_n}, "
                                       f"fill {fill}): max |err| {err}")
        print(f"kernel check gamma2d {shape} dta {dta}: bit-equal to twin, global and local "
              f"normalisation, fill NaN and -1")
    ref_n, eval_p = gamma_inputs((1, 8, 8), 1, False, gen)
    for bad, what in (((ref_n.double(), eval_p.double()), "float64"),
                      ((ref_n.transpose(1, 2), eval_p), "non-contiguous"),
                      ((ref_n, eval_p[:, :-1]), "mis-padded")):
        try:
            gamma2d.gamma2d(*bad, 1, 2.0, 0.05, 0.0)
        except (TypeError, ValueError) as e:
            print(f"kernel check gamma2d {what}: raised {type(e).__name__}")
        else:
            raise RuntimeError(f"gamma2d accepted a {what} input")
    return worst


def sig(x):
    return 1.0 / (1 + np.exp(np.clip(-x, -60, 60)))


def gamma_pairs() -> tuple[np.ndarray, np.ndarray]:
    """The bench's 16 uint16 reference/evaluation pairs (``bench.py:733-755``,
    seed 0): square fields of half-width 256-280 px at 40000 counts, the
    evaluation shifted by N(0, 1.5) px and scaled by N(1, 0.01), both with
    N(0, 60) count noise."""
    h, w = GAMMA_H, GAMMA_W
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    refs = np.empty((GAMMA_PAIRS, h, w), np.uint16)
    evals = np.empty((GAMMA_PAIRS, h, w), np.uint16)
    for i in range(GAMMA_PAIRS):
        cy, cx = h / 2, w / 2
        half = 256 + (i % 4) * 8

        def field(cy, cx, amp):
            v = (sig((xx - (cx - half)) / 4) - sig((xx - (cx + half)) / 4))
            v *= (sig((yy - (cy - half)) / 4) - sig((yy - (cy + half)) / 4))
            return amp * v

        r = field(cy, cx, 40000) + rng.normal(0, 60, (h, w))
        e = (field(cy + rng.normal(0, 1.5), cx + rng.normal(0, 1.5),
                   40000 * (1 + rng.normal(0, 0.01)))
             + rng.normal(0, 60, (h, w)))
        refs[i] = np.clip(r, 0, 65535).astype(np.uint16)
        evals[i] = np.clip(e, 0, 65535).astype(np.uint16)
    return refs, evals


def gamma_oracle(reference: np.ndarray, evaluation: np.ndarray) -> np.ndarray:
    """The bench's float32 numpy oracle of one pair (``bench.py:772-790``),
    with its own copy of the disk. One change: ``bench.py:789`` blanks pixels
    below 5 % of the raw maximum, where ``gamma_2d`` blanks those whose
    normalised dose is below 0.05 (5 % of the 3 % dose criterion); the oracle
    takes ``gamma_2d``'s definition, so that the NaN masks can be compared."""
    h, w, dta = GAMMA_H, GAMMA_W, GAMMA_DTA
    r = dta + 1
    offsets = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
               if dy * dy + dx * dx < r * r]
    reference = reference.astype(np.float32)
    evaluation = evaluation.astype(np.float32)
    dose_ta = GAMMA_DOSE_TA / 100.0 * reference.max()
    ref_n = reference / dose_ta
    eval_n = evaluation / dose_ta
    eval_p = np.pad(eval_n, dta, mode="edge")
    min_gamma2 = np.full((h, w), GAMMA_CAP ** 2, np.float32)
    for dy, dx in offsets:
        shifted = eval_p[dta + dy: dta + dy + h, dta + dx: dta + dx + w]
        dd = shifted - ref_n
        cand = (dy * dy + dx * dx) / (dta * dta) + dd * dd
        np.minimum(min_gamma2, cand, out=min_gamma2)
    gamma = np.minimum(np.sqrt(min_gamma2), GAMMA_CAP)
    gamma[ref_n < GAMMA_THRESH / 100.0] = np.nan
    return gamma


def compare_gamma(got: np.ndarray, want: np.ndarray, tol: float, what: str) -> float:
    """Equal NaN masks and |got - want| <= tol elsewhere; returns the
    largest difference."""
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        raise RuntimeError(f"{what}: NaN masks differ in {int((np.isnan(got) != nan).sum())} px")
    err = float(np.abs(got[~nan] - want[~nan]).max())
    if err > tol:
        raise RuntimeError(f"{what}: max |diff| {err} > {tol}")
    return err


def profile_gamma(card: str, run, wall_ms: float, top: int = 12) -> None:
    """Where a warm ``gamma_2d_batch`` with the result fetched spends its
    time: one run under ``torch.profiler`` after one profiled warm-up step
    (without it the tracer can miss the first copies), the device busy time
    against the profiled and the unprofiled wall, and the device work
    (copies and kernels) by self time."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            wall = (time.perf_counter() - t0) * 1e3
            prof.step()
    # the step's own annotation spans the step on the device: not work
    rows = {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")}
    busy = sum(ms for ms, _ in rows.values())
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    print(f"[{card}] gamma profile: profiled wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {100 * (1 - busy / wall):.1f} % of the profiled wall and "
          f"{100 * (1 - busy / wall_ms):.1f} % of the unprofiled median {wall_ms:.3f} ms")
    for key, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  device {ms:9.3f} ms  {n:5d} x  {key[:100]}")


def gamma_stages(card: str, refs: np.ndarray, evals: np.ndarray, kw: dict) -> None:
    """The stages of a warm ``gamma_2d_batch`` with the fetch, each between
    CUDA events (median of 5 after 1 warm-up): staging (the pageable
    host-to-device copies of both stacks and their widening), the prologue
    and the kernel, and the fetch. A cross-check of the profiler, whose
    trace can miss a pageable host-to-device copy."""
    from pylinac_tpu_torch.ops import gamma as tgamma

    runs = []
    for _ in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        marks[0].record()
        r, e = tgamma._stage(refs, torch.device("cuda")), tgamma._stage(evals, torch.device("cuda"))
        marks[1].record()
        out = tgamma._gamma_2d_staged(
            r, e, kw["dose_to_agreement"], kw["distance_to_agreement"], kw["gamma_cap_value"],
            kw["global_dose"], kw["dose_threshold"], float("nan"))
        marks[2].record()
        out.cpu()
        marks[3].record()
        torch.cuda.synchronize()
        runs.append([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    stage, compute, fetch = (statistics.median(col) for col in zip(*runs[1:]))
    print(f"[{card}] gamma stages by CUDA events, median of 5: staging {stage:.3f} ms, "
          f"prologue + kernel {compute:.3f} ms, fetch {fetch:.3f} ms, sum "
          f"{stage + compute + fetch:.3f} ms")


def gamma_phase(card: str, gamma2d) -> dict:
    """The 2D gamma path: kernel checks, the bench's 16 pairs through
    ``gamma_2d_batch`` and pair 0 through ``gamma_2d`` on the card, the
    kernel held against its twin on every input those runs gave it, the
    results against the numpy oracle and the CPU run, timing and a profile.
    Returns the gamma kernel's line."""
    from pylinac_tpu_torch.ops import gamma as tgamma

    max_abs_err = check_gamma(gamma2d)
    t0 = time.perf_counter()
    refs, evals = gamma_pairs()
    print(f"inputs: {GAMMA_PAIRS} gamma pairs {refs.shape[1:]} {refs.dtype} in "
          f"{time.perf_counter() - t0:.1f} s")
    kw = dict(dose_to_agreement=GAMMA_DOSE_TA, distance_to_agreement=GAMMA_DTA,
              gamma_cap_value=GAMMA_CAP, global_dose=True, dose_threshold=GAMMA_THRESH)

    gamma2d.gamma2d.launches = 0
    with recording_inputs([(tgamma, "gamma2d", "gamma")]) as seen:
        batch = tgamma.gamma_2d_batch(refs, evals, device="cuda", **kw)
        single = tgamma.gamma_2d(refs[0], evals[0], device="cuda", **kw)
    torch.cuda.synchronize()
    launches = gamma2d.gamma2d.launches
    if launches < 2:
        raise RuntimeError(f"the gamma path launched gamma2d {launches} times, want 2")
    print(f"gamma path: gamma2d.launches = {launches} (the batch and the single pair)")
    check_counts(seen, {"gamma": launches}, "gamma run")
    max_abs_err = max(max_abs_err, check_path_masks(
        {"gamma": (gamma2d.gamma2d, gamma2d.gamma2d_reference)}, seen, "gamma run")["gamma"])

    batch_np = batch.cpu().numpy()
    if batch_np.shape != (GAMMA_PAIRS, GAMMA_H, GAMMA_W) or batch.dtype != torch.float32:
        raise RuntimeError(f"gamma_2d_batch gave {batch.dtype} {tuple(batch.shape)}")
    if not torch.equal(torch.isnan(single), torch.isnan(batch[0])) or not torch.equal(
            torch.nan_to_num(single), torch.nan_to_num(batch[0])):
        raise RuntimeError("gamma_2d on pair 0 differs from the batch's pair 0")
    finite = np.isfinite(batch_np)
    passing = float((batch_np[finite] <= 1).mean())
    if not (0.2 < finite.mean() < 1 and passing > 0.5):
        raise RuntimeError(f"implausible gamma maps: {finite.mean():.3f} of pixels evaluated, "
                           f"{passing:.3f} of them passing")
    t0 = time.perf_counter()
    oracle_err = max(compare_gamma(batch_np[i], gamma_oracle(refs[i], evals[i]),
                                   GAMMA_ORACLE_TOL, f"gamma pair {i} vs numpy oracle")
                     for i in range(GAMMA_PAIRS))
    print(f"gamma results: {GAMMA_PAIRS} maps {batch_np.shape[1:]}, {finite.mean():.4f} of "
          f"pixels evaluated, {passing:.4f} of those passing (gamma <= 1); all {GAMMA_PAIRS} "
          f"pairs against the float32 numpy oracle: NaN masks equal, max |diff| {oracle_err:.3e} "
          f"(bar {GAMMA_ORACLE_TOL}; {time.perf_counter() - t0:.1f} s); gamma_2d on pair 0 "
          f"equal to the batch's pair 0")
    t0 = time.perf_counter()
    cpu = tgamma.gamma_2d_batch(refs, evals, device="cpu", **kw).numpy()
    cpu_err = compare_gamma(batch_np, cpu, GAMMA_CPU_TOL, "gamma card vs CPU")
    print(f"gamma card vs CPU on all {GAMMA_PAIRS} pairs: NaN masks equal, max |diff| "
          f"{cpu_err:.3e} (bar {GAMMA_CPU_TOL}; CPU run {time.perf_counter() - t0:.1f} s)")

    def run(fetch: bool):
        out = tgamma.gamma_2d_batch(refs, evals, device="cuda", **kw)
        if fetch:
            out = out.cpu()
        torch.cuda.synchronize()

    walls = {}
    for fetch in (False, True):
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            run(fetch)
            times.append((time.perf_counter() - t0) * 1e3)
        walls[fetch] = statistics.median(times[1:])
        print(f"[{card}] warm gamma_2d_batch of {GAMMA_PAIRS} pairs"
              f"{' with .cpu()' if fetch else ', result on the card'}: median "
              f"{walls[fetch]:.3f} ms of 5 runs = {GAMMA_PAIRS / walls[fetch] * 1e3:.1f} pairs/s "
              f"(runs ms: {', '.join(f'{t:.3f}' for t in times[1:])})")
    profile_gamma(card, functools.partial(run, True), walls[True])
    gamma_stages(card, refs, evals, kw)

    _, ref_n, (eval_p, dta, cap, threshold_n, fill), _ = max(seen, key=lambda s: s[1].numel())
    n_offsets = len(gamma2d.offset_table(dta)[1])
    ms, plain_ms = time_pair(
        lambda r: gamma2d.gamma2d(r, eval_p, dta, cap, threshold_n, fill),
        lambda r: gamma2d.gamma2d_reference(r, eval_p, dta, cap, threshold_n, fill),
        ref_n, 20, 3)
    # reference and padded evaluation in, the map out; per pixel and offset
    # four float32 instructions that may not fuse: sub, mul, add, min
    bound_ms, bound_by = bound(4 * (2 * ref_n.numel() + eval_p.numel()),
                               4 * n_offsets * ref_n.numel(), F32_INSTR_PER_S)
    print(f"[{card}] gamma2d at {tuple(ref_n.shape)} dta {dta} ({n_offsets} offsets): kernel "
          f"{ms:.4f} ms, plain twin {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    # the single pair's launch, the run's other one
    _, ref_1, (eval_1, *_), _ = min(seen, key=lambda s: s[1].numel())
    ms_1, plain_1 = time_pair(
        lambda r: gamma2d.gamma2d(r, eval_1, dta, cap, threshold_n, fill),
        lambda r: gamma2d.gamma2d_reference(r, eval_1, dta, cap, threshold_n, fill),
        ref_1, 20, 3)
    bound_1, _ = bound(4 * (2 * ref_1.numel() + eval_1.numel()), 4 * n_offsets * ref_1.numel(),
                       F32_INSTR_PER_S)
    print(f"[{card}] gamma2d at {tuple(ref_1.shape)} dta {dta} (the single pair): kernel "
          f"{ms_1:.4f} ms, plain twin {plain_1:.3f} ms, bound {bound_1:.4f} ms")
    return {"name": "gamma2d", "route": "cuda", "source": "pylinac_tpu_torch/csrc/gamma2d.cu",
            "replaces": "pylinac_tpu/ops/pallas_gamma.py:27", "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# the bench's FieldAnalysis (bench.py:214-240): 64 AS1000 frames at SID 1000
# from 4 files, field (100 + 5 i) x 100 mm with flattening-filter horns,
# blurred by sigma 1 mm, analysed with inflection-derivative edges
FA_FRAMES, FA_FILES = 64, 4
FA_EDGES = ("Inflection Derivative", "FWHM", "Inflection Hill")
FA_PROTOCOLS = ("VARIAN", "ELEKTA", "SIEMENS")
FA_TRUTH_TOL = 0.5        # mm, against the simulated field (test_field_analysis_batch.py:111)
# the single image against the batch's frame 0: the bars of
# tests/models/test_field_analysis_batch.py:60-100
FA_SINGLE_MM, FA_SINGLE_TOP_MM, FA_SINGLE_BC_PX = 0.01, 2.0, 0.05
FA_SINGLE_SLOPE, FA_SINGLE_ROI_REL = 0.02, 1e-4
# a mirror-symmetric field's point-difference symmetry is a tie between two
# mirror points of opposite sign (|value| about 6e-4 % on the bench's
# frames), so its sign is asserted only above this magnitude; the
# asymmetric frame's symmetries are far above it
FA_SYM_TIE = 0.01
# the full-frame entry against the strip route: the card-vs-CPU bars, and
# central-ROI statistics within 1e-6 of the host's float64 ones (relative;
# absolute for a zero std). Measured on the CPU at the bench's frames: 0.
FA_ROI_REL = 1e-6


def make_fields(tmp: str) -> list[str]:
    """The bench's four AS1000 open-field DICOMs (bench.py:223-231)."""
    from pylinac_tpu_torch.imggen.layers import FilteredFieldLayer, GaussianFilterLayer
    from pylinac_tpu_torch.imggen.simulators import AS1000Image

    paths = []
    for i in range(FA_FILES):
        path = f"{tmp}/f{i}.dcm"
        sim = AS1000Image(sid=1000)
        sim.add_layer(FilteredFieldLayer(field_size_mm=(100 + 5 * i, 100)))
        sim.add_layer(GaussianFilterLayer(sigma_mm=1))
        sim.generate_dicom(path)
        paths.append(path)
    return paths


def _scipy_fwxm_ips(v: np.ndarray, rel_height: float = 0.5):
    """The most prominent peak's interpolated crossings (scipy peak_widths);
    a copy of ``bench.py:57``."""
    import scipy.signal as sps

    peaks, props = sps.find_peaks(v, prominence=0.0)
    if len(peaks) == 0:
        return np.nan, np.nan
    best = int(np.argmax(props["prominences"]))
    w = sps.peak_widths(v, peaks[best:best + 1], rel_height=rel_height)
    return float(w[2][0]), float(w[3][0])


def _resample_linear_np(v: np.ndarray, samples: int):
    """The BMF half-pixel linear resample; a copy of ``bench.py:67``."""
    n = len(v)
    f = samples / n
    offset = 0.5 - 1.0 / (2.0 * f)
    new_x = np.linspace(-offset, n - 1 + offset, samples)
    inner = np.interp(new_x, np.arange(n), v)
    inner[new_x < 0] = v[0] + (new_x[new_x < 0]) * (v[1] - v[0])
    over = new_x > n - 1
    inner[over] = v[-1] + (new_x[over] - (n - 1)) * (v[-1] - v[-2])
    return inner, new_x


def fa_oracle(arr: np.ndarray, dpmm: float) -> dict:
    """The bench's numpy/scipy FieldAnalysis oracle (``bench.py:245-305``,
    inflection-derivative edges): field sizes, flatness and symmetry of
    one frame."""
    import scipy.ndimage as ndi
    import scipy.signal as sps

    H, W = arr.shape

    def beam_center_ratio(sums):
        v, _ = _resample_linear_np(sums, int(round(len(sums) * 10)))
        v = v - v.min()
        lo, hi = _scipy_fwxm_ips(v, 0.5)
        n = len(sums)
        f = len(v) / n
        off = 0.5 - 1 / (2 * f)
        dx = (n - 1 + 2 * off) / (len(v) - 1)
        return (-off + dx * (lo + hi) / 2) / n

    vp = beam_center_ratio(arr.sum(axis=0))
    hp = beam_center_ratio(arr.sum(axis=1))
    lv = max(int(round(W * vp)), 0)
    uh = max(int(round(H * hp)), 0)
    out = {}
    for name, vals in (("v", arr[:, lv:lv + 1].mean(axis=1)), ("h", arr[uh:uh + 1, :].mean(axis=0))):
        samples = int(round(len(vals) / (dpmm * 0.1)))
        v, new_x = _resample_linear_np(vals, samples)
        v = v - v.min()
        d1 = np.gradient(ndi.gaussian_filter1d(v, 0.003 * samples))
        sep = max(int(0.05 * samples), 1)
        pk_l, _ = sps.find_peaks(d1, height=d1.min() + 0.8 * np.ptp(d1), distance=sep)
        pk_r, _ = sps.find_peaks(-d1, height=(-d1).min() + 0.8 * np.ptp(-d1), distance=sep)
        left, right = new_x[pk_l[0]], new_x[pk_r[-1]]
        center = (left + right) / 2
        v = v / np.interp(round(center), new_x, v)
        width = right - left
        m = (new_x >= center - 0.8 * width / 2) & (new_x <= center + 0.8 * width / 2)
        fv = v[m]
        out[f"{name}_flat"] = 100 * abs(fv.max() - fv.min()) / (fv.max() + fv.min())
        sym = 100 * (fv - fv[::-1]) / np.interp(round(center), new_x, v)
        out[f"{name}_sym"] = sym[int(np.argmax(np.abs(sym)))]
        out[f"{name}_size"] = width / dpmm
    return out


def fa_texts(results) -> list[dict]:
    """FieldResults as JSON-loaded dicts (pairs as lists)."""
    return [json.loads(r.model_dump_json()) for r in results]


def fa_tol(path: str, a: float) -> float:
    """FieldAnalysis's bars: percentages (protocol results, slopes and
    penumbra gradients) within PCT_TOL, indices within PX_TOL px, mm within
    MM_TOL; the central ROI is host statistics and must be equal."""
    if "central_roi" in path:
        return 0.0
    if "protocol_results" in path or "percent" in path:
        return PCT_TOL
    if "index" in path:
        return PX_TOL
    return MM_TOL


def check_fa_bench(results, batch, what: str, oracle: dict) -> None:
    """Frames 0-3 against the bench's oracle (field sizes within MM_TOL) and
    the simulated fields (within FA_TRUTH_TOL of the field the simulator
    drew: its size rounded to an even number of pixels). ``oracle`` keeps
    the oracle's answers by frame content."""
    from pylinac_tpu_torch.imggen.layers import even_round
    from pylinac_tpu_torch.imggen.simulators import AS1000Image

    px = AS1000Image.pixel_size
    dpmm = float(batch.images[0].dpmm)
    worst = 0.0
    for i in range(FA_FILES):
        arr = np.asarray(batch.images[i].array, np.float32)
        key = arr.tobytes()
        if key not in oracle:
            oracle[key] = fa_oracle(arr, dpmm)
        base = oracle[key]
        r = results[i]
        for got, want, truth, name in (
                (r.field_size_vertical_mm, base["v_size"], even_round((100 + 5 * i) / px) * px,
                 "vertical"),
                (r.field_size_horizontal_mm, base["h_size"], even_round(100 / px) * px,
                 "horizontal")):
            worst = max(worst, abs(got - want))
            if abs(got - want) > MM_TOL:
                raise RuntimeError(f"{what} frame {i}: {name} field size {got} mm, bench "
                                   f"oracle {want} mm")
            if abs(got - truth) > FA_TRUTH_TOL:
                raise RuntimeError(f"{what} frame {i}: {name} field size {got} mm, field {truth}")
    print(f"{what}: frames 0-{FA_FILES - 1} field sizes within {worst:.2e} mm of the bench's "
          f"oracle and within {FA_TRUTH_TOL} mm of the simulated fields")


def check_fa_single(single, frame, what: str) -> None:
    """A single-image result against the batch's frame at the bars of
    ``tests/models/test_field_analysis_batch.py``, with the sign of each
    symmetry equal where it is not a mirror tie (FA_SYM_TIE)."""
    mm_fields = [
        "top_penumbra_mm", "bottom_penumbra_mm", "left_penumbra_mm", "right_penumbra_mm",
        "field_size_vertical_mm", "field_size_horizontal_mm", "beam_center_to_top_mm",
        "beam_center_to_bottom_mm", "beam_center_to_left_mm", "beam_center_to_right_mm",
        "cax_to_top_mm", "cax_to_bottom_mm", "cax_to_left_mm", "cax_to_right_mm"]
    checks = [(f, FA_SINGLE_MM) for f in mm_fields]
    checks += [(f, FA_SINGLE_TOP_MM) for f in ("top_vertical_distance_from_cax_mm",
                                               "top_horizontal_distance_from_cax_mm")]
    checks += [(f, FA_SINGLE_SLOPE) for f in ("left_slope_percent_mm", "top_slope_percent_mm")]
    for name, tol in checks:
        a, b = getattr(single, name), getattr(frame, name)
        if abs(a - b) > tol:
            raise RuntimeError(f"{what}: {name} {a} vs the batch's {b} (bar {tol})")
    for name, tol in (("beam_center_index_x_y", FA_SINGLE_BC_PX),
                      ("geometric_center_index_x_y", PX_TOL)):
        if max(abs(x - y) for x, y in zip(getattr(single, name), getattr(frame, name))) > tol:
            raise RuntimeError(f"{what}: {name} {getattr(single, name)} vs "
                               f"{getattr(frame, name)}")
    for key, a in single.protocol_results.items():
        b = frame.protocol_results[key]
        tie = max(abs(a), abs(b)) <= FA_SYM_TIE
        if abs(a - b) > PCT_TOL or (key.startswith("symmetry") and not tie
                                    and np.sign(a) != np.sign(b)):
            raise RuntimeError(f"{what}: {key} {a} vs the batch's {b}")
    if abs(single.central_roi_mean / frame.central_roi_mean - 1) > FA_SINGLE_ROI_REL:
        raise RuntimeError(f"{what}: central ROI mean {single.central_roi_mean} vs "
                           f"{frame.central_roi_mean}")


def compare_full_frame(full: dict, strips: dict) -> float:
    """The full-frame entry's fetched outputs against the strip route's:
    each profile scalar within the card-vs-CPU bars by its unit, the central
    ROI statistics within FA_ROI_REL. Returns the largest mm difference."""
    worst = 0.0
    for side in ("vert", "horiz"):
        for key, want in strips[side].items():
            got = full[side][key]
            tol = (PX_TOL if key.endswith("_idx") else
                   PCT_TOL if key in ("flatness", "symmetry") or "pct" in key else MM_TOL)
            diff = float(np.abs(got - want).max())
            if diff > tol:
                raise RuntimeError(f"full-frame entry: {side} {key} differs from the strip "
                                   f"route by {diff} (bar {tol})")
            if key.endswith("_mm"):
                worst = max(worst, diff)
    for key, want in strips["central_roi"].items():
        got = full["central_roi"][key]
        if np.any(np.abs(got - want) > FA_ROI_REL * np.maximum(np.abs(want), 1.0)):
            raise RuntimeError(f"full-frame entry: central ROI {key} {got} vs {want}")
    return worst


def fa_phase(card: str, median) -> tuple[int, float]:
    """The FieldAnalysis path: the bench's 64 frames through
    ``FieldAnalysisBatch`` on the card under each edge method and protocol
    (the bench's oracle, the simulated fields, the CPU run), the filter
    route with the median kernel counted and held to its twin on the stack
    it was given, the full-frame entry against the strip route, the
    single-image classes, repeated runs equal, then frames/s, a profile and
    a cProfile split. Returns the filter route's median3x3 launches and the
    kernel's largest error against its twin there."""
    from pylinac_tpu_torch import FieldAnalysis, FieldAnalysisBatch, Protocol
    from pylinac_tpu_torch.core.array_utils import median3x3_array
    from pylinac_tpu_torch.field_analysis import _fetch
    from pylinac_tpu_torch.imggen.layers import (FilteredFieldLayer, FilterFreeFieldLayer,
                                                 GaussianFilterLayer, SlopeLayer)
    from pylinac_tpu_torch.imggen.simulators import AS1000Image
    from pylinac_tpu_torch.ops import field_pipeline
    from pylinac_tpu_torch.ops import filters as tfilters

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fa_")
    try:
        t0 = time.perf_counter()
        paths = make_fields(tmp)
        frames = [paths[i % FA_FILES] for i in range(FA_FRAMES)]
        batch = FieldAnalysisBatch(frames, device="cuda")
        print(f"inputs: {FA_FRAMES} FA frames {batch.images[0].shape} "
              f"{batch.images[0].array.dtype}, dpmm {batch.images[0].dpmm:.4f}, in "
              f"{time.perf_counter() - t0:.1f} s")

        # every edge method under every protocol on the card, each held to
        # the CPU run of the four files (frame i is file i % 4; the batch's
        # rows are independent, so the CPU's four rows are its 64)
        cpu = FieldAnalysisBatch(paths, device="cpu")
        oracle = {}
        for edge in FA_EDGES:
            for name in FA_PROTOCOLS:
                kw = dict(protocol=getattr(Protocol, name), edge_detection_method=edge)
                batch.analyze(device="cuda", **kw)
                results = batch.results_data()
                cpu.analyze(device="cpu", **kw)
                want = fa_texts(cpu.results_data())
                worst = compare_tree([want[i % FA_FILES] for i in range(FA_FRAMES)],
                                     fa_texts(results), f"FA {edge} {name} CPU vs card", fa_tol)
                print(f"FA {edge}, {name}: card vs CPU on {FA_FRAMES} frames agree (max "
                      f"difference {worst:.2e})")
                if edge == "Inflection Derivative":
                    check_fa_bench(results, batch, f"FA {edge} {name}", oracle)

        # the filter route: one median3x3 launch on the stacked frames
        median.median3x3.launches = 0
        with recording_inputs([(tfilters, "median3x3", "median")]) as seen:
            filtered = FieldAnalysisBatch(frames, filter=3, device="cuda")
            filtered.analyze(edge_detection_method="Inflection Derivative")
            filtered_results = filtered.results_data()
        torch.cuda.synchronize()
        launches = median.median3x3.launches
        if launches < 1:
            raise RuntimeError("the FA filter route launched no median3x3 kernel")
        check_counts(seen, {"median": launches}, "FA filter run")
        err = check_path_masks({"median": (median.median3x3, median.median3x3_reference)},
                               seen, "FA filter run")["median"]
        check_fa_bench(filtered_results, filtered, "FA filter=3", oracle)
        stack = seen[0][1]
        print(f"FA filter route: median3x3.launches = {launches} on {tuple(stack.shape)}")
        ms, plain_ms = time_pair(median.median3x3, median.median3x3_reference, stack, 50, 5)
        bound_ms, bound_by = bound(8 * stack.numel(), 21 * stack.numel(), F32_INSTR_PER_S)
        print(f"[{card}] median3x3 at {tuple(stack.shape)}: kernel {ms:.4f} ms, plain twin "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")

        # an int32 image (frame 0 times 30000, past where float32 is exact)
        # takes the kernel too, in int32
        wide = np.asarray(batch.images[0].array).astype(np.int32) * 30000
        before = median.median3x3.launches
        got = median3x3_array(wide, "cuda")
        if median.median3x3.launches != before + 1:
            raise RuntimeError("the int32 filter route launched no median3x3 kernel")
        if not np.array_equal(got, median3x3_array(wide, "cpu")):
            raise RuntimeError("the int32 filter route differs on the card and the CPU")
        print(f"FA filter route, int32 image {wide.shape}: one median3x3 launch, equal to the CPU")

        # the single-image classes: frame 0 through the filter route, an
        # asymmetric frame, and an FFF frame under every edge method
        single = FieldAnalysis(paths[0], filter=3, device="cuda")
        single.analyze(edge_detection_method="Inflection Derivative")
        check_fa_single(single.results_data(), filtered_results[0],
                        "FieldAnalysis(filter=3) on frame 0")
        extra = {"asymmetric": [FilteredFieldLayer(field_size_mm=(110, 90), cax_offset_mm=(3, -2)),
                                GaussianFilterLayer(sigma_mm=1), SlopeLayer(0.05, -0.03)],
                 "fff": [FilterFreeFieldLayer(field_size_mm=(100, 100)),
                         GaussianFilterLayer(sigma_mm=1)]}
        for name, layers in extra.items():
            sim = AS1000Image(sid=1000)
            for layer in layers:
                sim.add_layer(layer)
            sim.generate_dicom(f"{tmp}/{name}.dcm")
        asym = f"{tmp}/asymmetric.dcm"
        one = FieldAnalysis(asym)
        one.analyze(edge_detection_method="Inflection Derivative")
        r = one.results_data()
        asym_batch = FieldAnalysisBatch([asym], device="cuda")
        asym_batch.analyze(edge_detection_method="Inflection Derivative")
        check_fa_single(r, asym_batch.results_data()[0], "the asymmetric frame")
        if min(abs(v) for k, v in r.protocol_results.items() if k.startswith("symmetry")) \
                <= FA_SYM_TIE:
            raise RuntimeError(f"the asymmetric frame is symmetric: {r.protocol_results}")
        fff = f"{tmp}/fff.dcm"
        for edge in FA_EDGES:
            one = FieldAnalysis(fff)
            one.analyze(is_FFF=True, edge_detection_method=edge)
            r = one.results_data()
            fff_batch = FieldAnalysisBatch([fff], device="cuda")
            fff_batch.analyze(is_FFF=True, edge_detection_method=edge)
            b = fff_batch.results_data()[0]
            check_fa_single(r, b, f"FFF frame, {edge}")
            for got in (r, b):
                if (abs(got.field_size_vertical_mm - 100) > 1.0
                        or abs(got.top_vertical_distance_from_cax_mm) > 1.0
                        or abs(got.top_horizontal_distance_from_cax_mm) > 1.0):
                    raise RuntimeError(f"FFF frame, {edge}: field {got.field_size_vertical_mm} "
                                       f"mm, top {got.top_position_index_x_y}")
            for name in ("top_vertical_distance_from_cax_mm",
                         "top_horizontal_distance_from_cax_mm"):
                if abs(getattr(r, name) - getattr(b, name)) > MM_TOL:
                    raise RuntimeError(f"FFF frame, {edge}: single {name} {getattr(r, name)} "
                                       f"vs batch {getattr(b, name)}")
        print(f"FA single images inside the batch bars: FieldAnalysis(filter=3) on frame 0 "
              f"(symmetries {single.results_data().protocol_results}, mirror ties below "
              f"{FA_SYM_TIE} %), the asymmetric frame (symmetry signs equal), the FFF frame "
              f"under {', '.join(FA_EDGES)} (field within 1 mm of 100, top within 1 mm of the "
              f"CAX, single and batch tops within {MM_TOL} mm)")

        # the full-frame entry against the strip route, on the card
        dpmm = float(batch.images[0].dpmm)
        H, W = batch.images[0].shape
        stack_u16 = np.stack([np.asarray(im.array) for im in batch.images])
        params = field_pipeline.FAParams.from_vector(
            [dpmm, 0.8, 0.2, 20, 80, 0.5, 0.5, 0, 0], "cuda")
        static = dict(samples_v=int(round(H / (dpmm * 0.1))),
                      samples_h=int(round(W / (dpmm * 0.1))), centering="Beam center",
                      normalization="Beam center", flatness="difference",
                      symmetry="point difference")

        def full_frame(edge: str) -> dict:
            out = field_pipeline.field_analysis_batch(stack_u16, params, edge=edge,
                                                      device="cuda", **static)
            fetched = _fetch({k: out[k] for k in ("vert", "horiz", "central_roi")})
            torch.cuda.synchronize()
            return fetched

        for edge in FA_EDGES:
            batch.analyze(edge_detection_method=edge, device="cuda")
            worst = compare_full_frame(full_frame(edge), batch._out)
            print(f"FA full-frame entry, {edge}: {FA_FRAMES} frames within {worst:.2e} mm of "
                  f"the strip route (bars {MM_TOL} mm, {PCT_TOL} %, {PX_TOL} px, ROI "
                  f"{FA_ROI_REL} relative)")

        # frames/s, every warm run's results equal to the first's
        walls = {}
        for edge in FA_EDGES:
            texts, times = [], []
            for _ in range(6):
                t0 = time.perf_counter()
                batch.analyze(edge_detection_method=edge, device="cuda")
                results = batch.results_data()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                texts.append(results_text(results))
            check_same_texts(texts, f"FA {edge} warm runs")
            walls[edge] = statistics.median(times[1:])
            print(f"[{card}] warm FieldAnalysisBatch {edge} analyze + results_data of "
                  f"{FA_FRAMES} frames: median {walls[edge]:.3f} ms of 5 runs = "
                  f"{FA_FRAMES / walls[edge] * 1e3:.1f} frames/s (runs ms: "
                  f"{', '.join(f'{t:.3f}' for t in times[1:])})")
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            full_frame("Inflection Derivative")
            times.append((time.perf_counter() - t0) * 1e3)
        full_ms = statistics.median(times[1:])
        print(f"[{card}] warm field_analysis_batch (full frames, uint16 from the host) of "
              f"{FA_FRAMES} frames, Inflection Derivative: median {full_ms:.3f} ms of 5 runs = "
              f"{FA_FRAMES / full_ms * 1e3:.1f} frames/s (runs ms: "
              f"{', '.join(f'{t:.3f}' for t in times[1:])})")

        def derivative_run():
            batch.analyze(edge_detection_method="Inflection Derivative", device="cuda")
            batch.results_data()
            torch.cuda.synchronize()

        for edge in ("Inflection Derivative", "Inflection Hill"):
            device_profile(card, f"FA {edge}", lambda e=edge: (
                batch.analyze(edge_detection_method=e, device="cuda"), batch.results_data(),
                torch.cuda.synchronize()), walls[edge], top=12)
        pr = cProfile.Profile()
        pr.enable()
        t0 = time.perf_counter()
        derivative_run()
        wall = (time.perf_counter() - t0) * 1e3
        pr.disable()
        out = io.StringIO()
        pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(15)
        print(f"[{card}] FA Inflection Derivative cProfile run wall {wall:.3f} ms "
              f"(by own time)")
        print(out.getvalue())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, err


def main() -> int:
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from pylinac_tpu_torch.ops import ccl, flood, gamma2d, median

    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    build_all([median.KERNEL, ccl.KERNEL, flood.KERNEL, gamma2d.KERNEL])
    t0 = time.perf_counter()
    kernels = [picket_fence_phase(card, median)]
    print(f"picket fence phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += catphan_phase(card, ccl)
    print(f"CatPhan phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += winston_lutz_phase(card, ccl, flood)
    print(f"Winston-Lutz phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels.append(gamma_phase(card, gamma2d))
    print(f"gamma phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fa_launches, fa_err = fa_phase(card, median)
    kernels[0]["launches"] += fa_launches
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], fa_err)
    print(f"FieldAnalysis phase: {time.perf_counter() - t0:.1f} s; whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
