#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pylinac_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and runs the ported paths:

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
  derivative run's host time with cProfile;
- Starshot: writes the bench's 16 stars (1000x1040 uint16, 5 spokes), runs
  ``StarshotBatch`` on the card against the bench's bars
  (``bench.py:341-352``) and the CPU run, a wobbly, a ladder-climbing and
  a film-like star on the card against the CPU, times the batch (every
  warm run's results equal to the first's), profiles it, times its
  batched Nelder-Mead on the card and on CPU tensors and the whole batch
  with its fits in each place, and holds the single-image ``Starshot`` to
  the batch and the drawn centre; this path runs no kernel of the port;
- single-image picket fence: two uncropped spiked AS1200 frames through
  ``PicketFence`` on the card, the de-spike's ``median3x3`` launches
  counted and each of their inputs held bit-equal to the twin (the kernel
  timed there), the results against the CPU run, ``PicketFenceBatch`` on
  the same frames and the drawn pickets; timed. Its launches join the
  median's entry of the kernels line;
- compressed DICOM: one seeded 512x512 uint16 frame through the port's
  ``dcmwrite`` and ``core/image.load`` in RLE, JPEG Lossless SV1, JPEG-LS
  and JPEG 2000, each equal to the frame, each host C++ decoder equal to
  its Python twin where there is one; the decode times a slice;
- CatPhan 700: four synthetic 80-slice scans of 512x512 int16 (0.5 mm
  pixels, 2.5 mm slices), scan 0 stored as JPEG Lossless SV1 and the rest
  uncompressed, through ``CatPhanBatch(model=CatPhan700)`` on the card,
  and scan 0 from a zip through ``CatPhan700.from_zip(...,
  memory_efficient_mode=True)``, every CCL input of both held bit-equal to
  its twin; the drawn phantom's bars (plugs, geometry, thickness, roll, a
  falling MTF with its 50 % point measured), the zipped scan against the
  batch and the CPU, warm runs equal; batch scans/s, the zipped scan's
  load and decode and its analyze timed apart, a profile;
- Winston-Lutz from a CBCT: 160 slices of 512x512 of a 5 mm BB as JPEG-LS
  in a zip, ``WinstonLutz.from_cbct_zip`` then ``analyze`` on the card
  (the batched BB window scan, every CCL input held to its twin), the
  reference's bars, card against CPU, warm runs equal; the projection
  build and the analyze timed apart, a profile with the hull's range;
- VMAT: a DRGS, a DRMLC and a DRCS pair of AS1200 frames (1280x1280
  uint16, SID 1000), each with one segment drawn 3 % hot, on the card:
  that segment the only one that fails, the DRCS spokes found, the card
  equal to the CPU, DRCS's size-10 median (the general sort) on the card
  equal to the CPU's; the DRGS pair written as .xim files and loaded as
  ``XIM``, its results equal to the DICOM pair's, the native .xim decode
  equal to its numpy twin, each timed; each analysis timed (this path
  launches no kernel of the port);
- DLG: one AS1200 frame with five drawn gaps, the measured DLG within
  0.15 mm of the drawn 0, timed (host code);
- Quart DVT: a generated 60-slice 512x512 series and a copy rolled 2
  degrees through ``QuartDVT.analyze`` on the card, the geometry module's
  ``median3x3`` launches and the localisation's and roll slice's CCL
  launches counted, every input held bit-equal to the twins; the drawn
  phantom's bars, card against CPU, warm runs equal, a profile, the
  kernels timed at these shapes with their bounds. Its median launches
  join the median's entry of the kernels line;
- ACR CT 464, ACR MRI Large, TomoCheese, CIRS 062M and GE Helios: the
  generated series at the sizes clinics scan (ACR CT 32 x 512x512 at 5 mm;
  ACR MRI 11 axial 512x512 at 10 mm with the sagittal localiser, and a
  two-echo copy; TomoCheese 24 x 512x512 and a copy rolled 2 degrees; GE
  Helios 40 x 512x512) and a CIRS 062M drawn with numpy (20 x 512x512),
  each through its class's ``analyze`` on the card with the CCL launches
  (the stack's localisation, the roll slice, the origin-slice searches of
  Helios and CIRS, the MR low-contrast regions) and the flood launches
  (the MR fills) counted and every input held bit-equal to the twins; the
  drawn truths (``tests/models/test_acr.py``, ``test_cheese.py`` and
  ``test_helios.py``'s bars), the two-echo copy's warning and results,
  card against CPU, warm runs equal, a profile of a warm ACR MRI run, and
  the kernels timed at every new shape with their bounds. Its flood
  launches join the single-image flood entry of the kernels line;
- planar imaging: a QC-3 drawn on an AS1200 frame (1280x1280, full
  detection: Canny, the 96 largest edge components, their regions), an
  FC-2 light/rad frame on AS1200 (150 mm field, the 15 x 15 BB set, every
  BB near the edge so each goes through the high-pass and a second 3x3
  median), the 13 long-tail phantoms and the 4 FC-2 variants on AS1000
  frames by the JAX tests' recipes, and the ACR mammography phantom drawn
  at 0.07 mm on a 2560x3328 frame, each through ``analyze`` on the card
  with the median's and the CCL kernel's launches counted and every input
  held bit-equal to the twins (Canny's hysteresis, ``keep_largest``,
  ``regionprops``, the BB windows, the fibres); the drawings' bars, card
  against CPU (mm 0.01, % 0.1, contrast, CNR and rMTF 0.1 %, px 1e-3; the
  mammography phantom at its 1024x768 test size), warm runs equal, a
  profile of a warm QC-3, the kernels timed at the new shapes; then
  ``FieldProfileAnalysis`` of an AS1200 open field under each edge (host
  code) against the drawn 150 mm. Its median launches join the median's
  entry of the kernels line;
- nuclear medicine: a two-frame 1024x1024 intrinsic flood at 0.56 mm
  (30 M counts a frame; NEMA bins it by 8), 120 COR projections of
  128x128 at 4.8 mm (the axis 0.5 px off the frame's centre), a 128^3
  reconstructed point source and a 128-slice Jaszczak cylinder with six
  cold spheres at 4.42 mm, four-bar and quadrant-bar frames of 1024x1024,
  a 120-frame dynamic series and sensitivity frames, all drawn with numpy
  and written as NM DICOM, through the nine classes of ``nuclear.py`` on
  the card: the CCL launches counted (128 + 128 for the cylinder's slice
  search) and every input held bit-equal to the twins, the drawn truths,
  card against CPU at the bars (the binary frames and FOVs equal), warm
  runs equal; the kernel timed at the phase's (1, 128, 128). Its lines
  join the kernels line as ``ccl_label_nuclear`` and ``ccl_holes_nuclear``;
- machine logs: one VMAT arc as a 4000-snapshot trajectory log (20 ms)
  and as a 1600-snapshot dynalog pair (50 ms), 120 Millennium leaves:
  the card's fluence equal over 11 runs and to the CPU's within 1e-6 of
  its maximum, gamma and RMS card against CPU, warm ms of ``calc_map``,
  its equal-aspect 4000x4000 form and the gamma; ``interval_fluence``
  timed at (60, 4001); a folder of 10 trajectory logs and 10 dynalog pairs
  through ``MachineLogs.avg_gamma`` and ``avg_gamma_pct`` against the CPU;
  ``PicketFence(path, log=...)`` on an AS1200 picket fence and its
  delivery log against the CPU, warm runs equal (this path launches the
  median kernel only if the de-spike fires);
- QA plans, contrib and calibration: every TrueBeam QA beam on a
  Millennium and an HD120 template and a Halcyon dual-stack picket fence,
  each plan written and read back; ``generate_fluences`` of each on the
  card at AS1200's grid and at 0.1 mm over 400 mm, equal to the CPU's in
  float32 and uint16; a picket fence plan rendered on an AS1200 by
  ``to_dicom_images`` (equal to the CPU's), 0.01 % hot pixels added, and
  ``PicketFence`` on it (its de-spike's ``median3x3`` launches counted, 7
  pickets within 0.5 mm of the plan, card against CPU);
  ``JawOrthogonality`` of an AS1200 150 mm field (Canny's hysteresis on
  ``ccl.cu``, edges, Hough space and angles equal to the CPU's, every
  corner within 0.5 degrees of 90; Canny and the host Hough timed
  apart); ``QuasarLightRadScaling``
  on an AS1200 frame (medians and BB windows on the kernels, card against
  CPU, scaling centres within 1e-3 px); every kernel input held bit-equal
  to its twin, warm runs timed; the TG-51 and TRS-398 worksheets with
  their PDFs on the host; whether matplotlib imports. Its lines join the
  kernels line as ``ccl_label_contrib``, ``ccl_holes_contrib`` and
  ``median3x3_contrib``;
- multi-device and reports: the PF batch of 64 frames and the CatPhan batch
  of 4 scans (kept from their phases), the FA batch of 64 frames, the gamma
  batch of 16 pairs and ``sharded_wl_centroids`` of the WL session's 8
  frames, each on ``make_mesh()`` (the one card) and on logical meshes of
  4 and 3 shards of it (``Mesh([cuda:0] * n)``; WL on the even ones),
  against the unsharded card run (bit-equal, or floats within the path's
  bar, printed), with every kernel input held bit-equal to its twin, the
  launches counted (at least one a shard) and the warm runs timed; then
  the PDF, QuAAC and plotly reports of a spiked PF frame and of CatPhan504
  scan 0 analysed on the card, against the CPU's (the PDF byte for byte).
  Its lines join the kernels line as ``median3x3_mesh``, ``ccl_label_mesh``,
  ``ccl_holes_mesh``, ``gamma2d_mesh`` and ``flood_mesh``;
- stage tables: one warm run each of the PF batch, the CatPhan batch and
  ACR CT under ``profiling.collect()``, and the launch and copy counts of
  a warm CatPhan batch under ``profiling.count_dispatches()``;
- multi-target Winston-Lutz: writes the SNC MultiMet session (6 BBs in 6
  fields of 20 mm, 8 AS1200 frames: gantry 0, 45, 135, 180, 225, 315 and
  gantry 0 at couch 45 and 315) and a copy with every BB 1 mm left, runs
  ``WinstonLutzMultiTargetMultiField`` on the card with every CCL input
  recorded: the field locator's whole-frame 8-connected labels and holes,
  the BB windows' 4-connected ones, each held bit-equal to its twin and
  the largest whole-frame mask ten more launches equal; checks every BB
  matched in every frame and the reference's bars, holds 2 frames to the
  CPU run, times the warm analysis (every run's results equal), profiles
  the 2-frame run (the hull's device time named) and times each kernel use
  against its twin. It runs last: its profile of an 8-frame run (177,000
  launches) left the profiler of a phase after it with no device events.

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
import os
import pstats
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
import zipfile
from collections import Counter
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
    shapes = [f"{shape} x {n}" if n > 1 else shape for shape, n in Counter(shapes).items()]
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
    """A typed result or its dict, or a list of them, as JSON without its
    ``date_of_analysis`` fields (nested ones too): the one field that a
    rerun must change."""
    def undated(x):
        if isinstance(x, dict):
            return {k: undated(v) for k, v in x.items() if k != "date_of_analysis"}
        return [undated(v) for v in x] if isinstance(x, list) else x

    if isinstance(result, list):
        return "\n".join(results_text(r) for r in result)
    data = result if isinstance(result, dict) else json.loads(result.model_dump_json())
    return json.dumps(undated(data))


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
        KEPT["pf_batch"] = batch
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
        stage_table(card, f"PicketFenceBatch of {N_FRAMES} frames",
                    lambda: (batch.analyze(tolerance=0.5, device="cuda"), batch.results_data()))

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
        KEPT["ct_batch"], KEPT["catphan504"] = batch, (single, cpu)

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
        stage_table(card, f"CatPhanBatch of {CT_SCANS} scans", warm_batch)
        from pylinac_tpu_torch import profiling

        with profiling.count_dispatches() as counts:
            warm_batch()
        print(f"[{card}] count_dispatches of a warm CatPhanBatch of {CT_SCANS} scans: "
              f"{json.dumps(counts.as_dict())}")

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


def device_profile(card: str, what: str, run, default_ms: float, top: int = 20,
                   ranges=()) -> None:
    """One ``run()`` under ``torch.profiler``: the device's busy time (the
    sum of the device kernels' self time) and its idle share against the
    profiled wall and against ``default_ms``, the unprofiled median; the
    device kernels by self time and the host ops by the device time of the
    kernels they launched; and the device time of the kernels launched
    inside each ``record_function`` range named in ``ranges``."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    tables = {"kernel": {}, "op": {}}
    in_range = {}
    for e in prof.key_averages():
        if e.key in ranges:
            if e.device_type == DeviceType.CPU:   # the host range: its kernels' device time
                in_range[e.key] = (e.device_time_total / 1e3, e.count)
        elif e.self_device_time_total > 0:
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
    for name in ranges:
        if name not in in_range:
            raise RuntimeError(f"torch.profiler recorded no {name} range")
        ms, n = in_range[name]
        print(f"  range  {ms:9.3f} ms  {n:5d} x  {name} "
              f"({100 * ms / busy:.1f} % of the device busy time)")


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


# the CatPhan 700 phase: 4 synthetic 80-slice scans of 512 x 512 int16 at
# 0.5 mm pixels and 2.5 mm slices (CTP404 at +70 mm, CTP486 at -90 mm),
# seeds CT_SEED + i; scan 0 stored as JPEG Lossless SV1, the rest uncompressed
CP700_SLICES = 80
CP700_HU_TOL = 40         # plug against its nominal HU
CP700_GEOMETRY_MM = 1.0   # node distance against 50 mm
CP700_THICKNESS_MM = 0.2  # slice thickness against 2.5 mm
CP700_ROLL_DEG = 0.1
# the kV CBCT of a 5 mm BB (tests/models/test_winstonlutz.py:124-157 at
# clinical width): 160 slices of 512 x 512 at 0.5 mm pixels and 1 mm slices,
# stored as JPEG-LS; the bars of test_winstonlutz.py:159-170
CBCT_SLICES = 160
CBCT_SIZE = 512
CBCT_BARS = {"max_2d_cax_to_bb_mm": (3.61, 0.2), "x": (1.0, 0.2), "y": (-3.0, 0.2),
             "z": (-2.0, 0.2)}
# the Nelder-Mead isocentre fits, held as check_cbct_fits says
CBCT_FIT_FIELDS = ("gantry_3d_iso_diameter_mm", "gantry_coll_3d_iso_diameter_mm")
WARM_RUNS = 6             # 1 warm-up, then the median of 5
CBCT_WARM_RUNS = 4        # 1 + 3: each run builds the 160-slice projections anew


def recompress(path: str, transfer_syntax: str) -> None:
    """Rewrite a DICOM file in ``transfer_syntax`` (a worker of the
    set-up's pool)."""
    from pylinac_tpu_torch.core import dcm

    dcm.dcmwrite(path, dcm.dcmread(path), transfer_syntax=transfer_syntax)


def zip_folder(folder: str, path: str) -> str:
    with zipfile.ZipFile(path, "w") as zf:
        for name in sorted(os.listdir(folder)):
            zf.write(os.path.join(folder, name), name)
    return path


def make_cp700_scans(tmp: str) -> tuple[list[str], str]:
    """The four CatPhan 700 scans, written in parallel, then scan 0's
    slices rewritten as JPEG Lossless SV1 in parallel and zipped. Returns
    the folders and scan 0's zip."""
    from pylinac_tpu_torch.core import dcm
    from pylinac_tpu_torch.imggen.ct import _generate_catphan700

    dirs = [f"{tmp}/cp700_{i}" for i in range(CT_SCANS)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(8, os.cpu_count() or 1), mp_context=ctx) as pool:
        futures = [pool.submit(_generate_catphan700, d, num_slices=CP700_SLICES,
                               seed=CT_SEED + i) for i, d in enumerate(dirs)]
        paths = [f.result() for f in futures]
        for f in [pool.submit(recompress, p, dcm.JPEG_LOSSLESS_SV1) for p in paths[0]]:
            f.result()
    return dirs, zip_folder(dirs[0], f"{tmp}/cp700_0.zip")


def check_cp700_results(results: list[dict], what: str) -> None:
    """The drawn phantom's bars on every scan: each of the 11 plugs within
    CP700_HU_TOL of its nominal HU and HU linearity passed, the nodes 50 mm
    apart within CP700_GEOMETRY_MM, the slice thickness 2.5 mm within
    CP700_THICKNESS_MM, the roll within CP700_ROLL_DEG of 0, and the MTF's
    50 % point inside the 0.1-0.8 lp/mm bar groups."""
    for i, r in enumerate(results):
        c404 = r["ctp404"]
        hu_err = max(abs(x["value"] - x["nominal_value"]) for x in c404["hu_rois"].values())
        checks = {
            "model 700, 80 slices": (r["catphan_model"], r["num_images"]) == ("700", CP700_SLICES),
            "11 plugs": len(c404["hu_rois"]) == 11,
            f"plugs within {CP700_HU_TOL} HU": hu_err < CP700_HU_TOL,
            "HU linearity passed": c404["hu_linearity_passed"],
            f"nodes 50 +- {CP700_GEOMETRY_MM} mm":
                abs(c404["avg_line_distance_mm"] - 50) < CP700_GEOMETRY_MM,
            "geometry passed": c404["geometry_passed"],
            f"thickness 2.5 +- {CP700_THICKNESS_MM} mm":
                abs(c404["measured_slice_thickness_mm"] - 2.5) < CP700_THICKNESS_MM,
            f"|roll| < {CP700_ROLL_DEG} deg": abs(r["catphan_roll_deg"]) < CP700_ROLL_DEG,
            "0.1 < mtf50 < 0.8": 0.1 < r["ctp528"]["mtf_lp_mm"]["50"] < 0.8,
            "start angle None": r["ctp528"]["start_angle_radians"] is None,
            "uniformity passed": r["ctp486"]["passed"],
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise RuntimeError(f"{what} scan {i} fails {failed}: {r}")
        print(f"{what} scan {i}: origin {r['origin_slice']}, roll {r['catphan_roll_deg']:.4f} "
              f"deg, nodes {c404['avg_line_distance_mm']:.4f} mm, thickness "
              f"{c404['measured_slice_thickness_mm']:.4f} mm, max HU error {hu_err:.1f}, mtf50 "
              f"{r['ctp528']['mtf_lp_mm']['50']:.4f} lp/mm: inside every bar")


def check_mtf_falls(ct, caught, what: str) -> None:
    """The eight bar groups' relative MTF must fall monotonically (no
    ``core/mtf.py:38`` warning) and its 50 % point must be measured (no
    extrapolation warning at 50 %)."""
    norm = list(ct.ctp528.mtf.norm_mtfs.values())
    messages = [str(w.message) for w in caught]
    if (len(norm) != 8 or any(a <= b for a, b in zip(norm, norm[1:]))
            or any("monotonically" in m or " 50%" in m for m in messages)):
        raise RuntimeError(f"{what}: the MTF does not fall over the 8 bar groups or its 50 % "
                           f"point is extrapolated: {norm}, {messages}")
    print(f"{what}: relative MTF over 0.1-0.8 lp/mm {[round(v, 4) for v in norm]}, falling")


def same_warnings(card_data: dict, cpu_data: dict, what: str) -> None:
    """Card and CPU ``results_data().warnings`` equal on (message,
    category)."""
    def proj(d):
        return [(w["message"], w["category"]) for w in d["warnings"]]

    if proj(card_data) != proj(cpu_data):
        raise RuntimeError(f"{what}: the card's warnings {proj(card_data)} are not the CPU's "
                           f"{proj(cpu_data)}")
    print(f"{what}: card and CPU warnings equal on (message, category): {proj(card_data)}")


def stage_table(card: str, what: str, run) -> None:
    """One warm ``run()`` under ``profiling.collect()``: its stage table
    (the JAX package's stage names, host wall clock; a stage ends where
    its code does, so queued device work is charged to whichever stage
    next waits for it)."""
    from pylinac_tpu_torch import profiling

    with profiling.collect() as times:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if not times.stages:
        raise RuntimeError(f"the {what} run timed no stage")
    print(f"[{card}] stage table of a warm {what} run (wall {wall:.1f} ms):")
    print(times.report())


def median_runs(card: str, what: str, run, n: int = WARM_RUNS) -> tuple[float, list]:
    """``run()`` n times (it synchronises the card itself); the median of
    all but the first wall, in ms, and every run's output."""
    times, outs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        outs.append(run())
        times.append((time.perf_counter() - t0) * 1e3)
    warm = statistics.median(times[1:])
    print(f"[{card}] {what}: median {warm:.1f} ms of {n - 1} runs "
          f"(runs ms: {', '.join(f'{t:.1f}' for t in times[1:])})")
    return warm, outs


def codec_checks(card: str) -> None:
    """One seeded 512 x 512 uint16 frame through the port's ``dcmwrite``
    and ``core/image.load`` in RLE, JPEG Lossless, JPEG-LS and JPEG 2000:
    each load must give the frame back, and each native decode must equal
    its Python twin where there is one. Then each syntax's decode time a
    slice, native (median of 5 after 1) and Python (one call)."""
    from pylinac_tpu_torch import native
    from pylinac_tpu_torch.core import compressed_px as cpx
    from pylinac_tpu_torch.core import dcm, image, jpegls

    frame = np.random.default_rng(CT_SEED).normal(1024, 300, (512, 512)).clip(0, 4095)
    frame = frame.astype(np.uint16)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_codecs_")
    try:
        for name, ts in (("RLE", dcm.RLE_LOSSLESS), ("JPEG Lossless SV1", dcm.JPEG_LOSSLESS_SV1),
                         ("JPEG-LS", dcm.JPEG_LS_LOSSLESS), ("JPEG 2000", dcm.J2K_LOSSLESS)):
            ds = dcm.Dataset()
            ds.Modality = "CT"
            ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
            ds.set_pixel_data(frame)
            path = f"{tmp}/{name.replace(' ', '_')}.dcm"
            dcm.dcmwrite(path, ds, transfer_syntax=ts)
            if not np.array_equal(image.load(path).array, frame):
                raise RuntimeError(f"{name}: image.load does not give the frame back")
            frag = dcm.dcmread(path).get("PixelData")[1]  # after the Basic Offset Table
            twin = {"RLE": lambda f: cpx.rle_decode_frame(f, 512, 512, 16),
                    "JPEG Lossless SV1": cpx.jpeg_lossless_decode,
                    "JPEG-LS": jpegls.jpegls_decode}.get(name)
            fast = {"RLE": None, "JPEG Lossless SV1": native.jpeg_lossless_native(),
                    "JPEG-LS": native.jpegls_native()[0],
                    "JPEG 2000": cpx.j2k_decode}[name]
            cells = [f"{os.path.getsize(path)} bytes"]
            if fast is not None:
                out = fast(frag)
                if not np.array_equal(out, frame):
                    raise RuntimeError(f"{name}: the native decode is not the frame")
                ms, _ = median_runs(card, f"{name} native decode of a 512 x 512 slice",
                                    lambda: fast(frag))
                cells.append(f"native {ms:.3f} ms")
            if twin is not None:
                t0 = time.perf_counter()
                out = twin(frag)
                py_ms = (time.perf_counter() - t0) * 1e3
                if not np.array_equal(out, frame):
                    raise RuntimeError(f"{name}: the Python twin is not the frame")
                cells.append(f"Python {py_ms:.1f} ms")
            print(f"[{card}] codec {name}: round trip through dcmwrite and image.load equal; "
                  f"native equal to the Python twin where both exist; " + ", ".join(cells))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def counted_ccl(ccl, run, what: str):
    """``run()`` with the CCL counts at 0 and every CCL input recorded,
    each held bit-equal to its twin. Returns (its output, its counts, its
    records, the largest error of each mode)."""
    ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
    with recording_inputs(ccl_entries()) as seen:
        out = run()
    torch.cuda.synchronize()
    counts = {"label": ccl.label_batch.launches, "holes": ccl.hole_roots_batch.launches}
    check_counts(seen, counts, what)
    if min(counts.values()) < 1:
        raise RuntimeError(f"the {what} launched a CCL mode no time: {counts}")
    errs = check_path_masks(kernel_pairs(ccl), seen, what)
    print(f"{what}: launches {counts}")
    return out, counts, seen, errs


def catphan700_phase(card: str, ccl) -> list[dict]:
    """CatPhan 700 from mixed compressed and uncompressed series: the
    4-scan ``CatPhanBatch`` on the card and scan 0 from a zip of JPEG
    Lossless slices in memory-efficient mode, both counted with every CCL
    input held to its twin; the drawn phantom's bars, batch against lazy
    single, card against CPU, warm runs equal; batch scans/s, the zipped
    scan's load and decode and its analyze as separate times, a profile.
    Returns the CCL kernel's two lines (label and holes)."""
    from pylinac_tpu_torch import ct
    from pylinac_tpu_torch.core.image import LazyZipDicomImageStack

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cp700_")
    try:
        t0 = time.perf_counter()
        dirs, zipped = make_cp700_scans(tmp)
        print(f"inputs: {CT_SCANS} CatPhan 700 scans x {CP700_SLICES} slices of 512 x 512 int16 "
              f"(scan 0 JPEG Lossless SV1, zipped {os.path.getsize(zipped) / 2**20:.1f} MiB) in "
              f"{time.perf_counter() - t0:.1f} s")

        def batch_run():
            batch = ct.CatPhanBatch(dirs, model=ct.CatPhan700)
            batch.analyze(device="cuda")
            return batch, batch.results_data(as_dict=True)

        def lazy_run(device="cuda"):
            single = ct.CatPhan700.from_zip(zipped, memory_efficient_mode=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                single.analyze(device=device)
                data = single.results_data(as_dict=True)
            return single, data, caught

        (batch, results), counts, seen, errs = counted_ccl(ccl, batch_run, "CatPhan 700 batch")
        check_cp700_results(results, "card CatPhan 700 batch")
        (single, single_data, caught), single_counts, single_seen, single_errs = counted_ccl(
            ccl, lazy_run, "CatPhan 700 lazy zipped scan")
        if not isinstance(single.dicom_stack, LazyZipDicomImageStack):
            raise RuntimeError("the zipped scan did not load as a lazy zip stack")
        check_cp700_results([single_data], "card CatPhan 700 lazy zipped")
        check_mtf_falls(single, caught, "card CatPhan 700 lazy zipped scan 0")
        worst = compare_tree(results[0], single_data, "batch scan 0 vs lazy zipped scan", ct_tol)
        exact = results_text(results[0]) == results_text(single_data)
        print(f"lazy zipped scan 0 vs batch scan 0: agree (max difference {worst:.2e}; "
              f"{'equal' if exact else 'NOT equal'} character for character)")

        t0 = time.perf_counter()
        _, cpu_data, _ = lazy_run("cpu")
        cpu_s = time.perf_counter() - t0
        worst = max(compare_tree(cpu_data, single_data, "CPU vs card lazy scan", ct_tol),
                    compare_tree(cpu_data, results[0], "CPU vs card batch", ct_tol))
        same_warnings(single_data, cpu_data, "CatPhan 700 scan 0")
        print(f"card vs CPU on scan 0 (the CPU run {cpu_s:.1f} s): agree (max difference "
              f"{worst:.2e})")

        def warm_batch():
            for scan in batch.cts:
                scan._slice_centroids = None  # a fresh localisation per run
            batch.analyze(device="cuda")
            data = batch.results_data()
            torch.cuda.synchronize()
            return data

        warm, outs = median_runs(card, f"warm CatPhanBatch(model=CatPhan700) analyze + "
                                 f"results_data of {CT_SCANS} scans", warm_batch)
        check_same_texts([results_text(o) for o in outs], "CatPhan 700 warm batches")
        print(f"[{card}] warm CatPhan 700 batch: {CT_SCANS / warm * 1e3:.3f} scans/s = "
              f"{CT_SCANS * CP700_SLICES / warm * 1e3:.1f} slices/s")

        def load_decode():
            scan = ct.CatPhan700.from_zip(zipped, memory_efficient_mode=True)
            scan._loc_stage_host()  # the one decode of the series
            return scan

        load_ms, scans = median_runs(card, "CatPhan700.from_zip(memory_efficient_mode=True) "
                                     "load + decode of 80 JPEG Lossless slices", load_decode)

        def analyze_scan():
            scan = scans.pop()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                scan.analyze(device="cuda")
                data = scan.results_data()
            torch.cuda.synchronize()
            return data

        analyze_ms, outs = median_runs(card, "lazy zipped CatPhan700 analyze + results_data "
                                       "(series decoded)", analyze_scan)
        check_same_texts([results_text(o) for o in outs], "CatPhan 700 lazy zipped warm runs")
        print(f"[{card}] lazy zipped CatPhan 700 scan: load + decode {load_ms:.1f} ms, analyze "
              f"{analyze_ms:.1f} ms")
        device_profile(card, "CatPhan 700 batch", warm_batch, warm)

        # the single scan's B = 1 launches (its roll slice and geometry
        # nodes), each shape timed apart
        for m, masks, args, kwargs in single_seen:
            if masks.shape[0] == 1:
                kernel, twin = kernel_pairs(ccl)[m]
                timed_pair(card, f"CatPhan 700 lazy scan ccl {m} (B = 1)",
                           lambda x: kernel(x, *args, **kwargs),
                           lambda x: twin(x, *args, **kwargs), masks, ccl_bound)

        lines = []
        for mode, replaces in (("label", "pylinac_tpu/ops/pallas_label.py:336"),
                               ("holes", "pylinac_tpu/ops/pallas_label.py:336")):
            masks, args, kwargs = largest_record(seen, mode)
            kernel, twin = kernel_pairs(ccl)[mode]
            lines.append(ccl_line(
                f"ccl_{mode}_cp700", replaces, counts[mode] + single_counts[mode],
                max(errs.get(mode, 0.0), single_errs.get(mode, 0.0)),
                timed_pair(card, f"CatPhan 700 ccl {mode} on the batch's largest input",
                           lambda x: kernel(x, *args, **kwargs),
                           lambda x: twin(x, *args, **kwargs), masks, ccl_bound)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


def check_cbct_results(wl, data: dict, what: str) -> None:
    """``tests/models/test_winstonlutz.py:159-170``'s bars: the BB planted
    (2, -1, 3) mm off gives a max 2D CAX-BB of 3.61 mm and a shift of
    (1, -3, -2) mm, each within 0.2 mm."""
    sv = wl.bb_shift_vector
    got = {"max_2d_cax_to_bb_mm": data["max_2d_cax_to_bb_mm"], "x": sv.x, "y": sv.y, "z": sv.z}
    failed = {k: v for k, v in got.items() if abs(v - CBCT_BARS[k][0]) > CBCT_BARS[k][1]}
    if failed or len(wl.images) != 4:
        raise RuntimeError(f"{what} fails the CBCT bars: {failed}, {len(wl.images)} views")
    print(f"{what}: 4 views, max 2D CAX-BB {got['max_2d_cax_to_bb_mm']:.4f} mm, shift "
          f"({sv.x:.4f}, {sv.y:.4f}, {sv.z:.4f}) mm: inside every bar")


def check_cbct_fits(wl, cpu_wl, data: dict, cpu_data: dict) -> None:
    """The 3D isocentre diameters of the CBCT, card against CPU. The float32
    Nelder-Mead from the origin (JAX's, kept for parity; ROADMAP section 3)
    stalls on some ray sets, and the card's rays differ from the CPU's in
    the last bits (the region sums' order), so these two fields are held
    by what the device path decides: each view's BB and field centre card
    against CPU within PX_TOL; each fit's value twice the largest float64
    distance from its point to its own rays (within 1e-5 mm); and the
    card's diameter no larger than the CPU's plus MM_TOL."""
    for a, b in zip(wl.images, cpu_wl.images):
        diff = max(abs(a.bb.x - b.bb.x), abs(a.bb.y - b.bb.y),
                   abs(a.field_cax.x - b.field_cax.x), abs(a.field_cax.y - b.field_cax.y))
        if diff > PX_TOL:
            raise RuntimeError(f"WL from CBCT: a view's BB or field centre differs from the "
                               f"CPU's by {diff} px")
    for which, session in (("card", wl), ("CPU", cpu_wl)):
        fit = session._minimize_axis()
        rays = [img.arrangement_matches["Iso"].bb_to_field_projection for img in session.images]
        p1 = np.array([[r.point1.x, r.point1.y, r.point1.z] for r in rays])
        d = np.array([[r.point2.x, r.point2.y, r.point2.z] for r in rays]) - p1
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        dist = np.linalg.norm(np.cross(d, fit.x.astype(np.float64) - p1), axis=1).max()
        if abs(2 * dist - 2 * fit.fun) > 1e-5:
            raise RuntimeError(f"WL from CBCT {which}: the fit reports {fit.fun} mm, its point's "
                               f"largest ray distance is {dist} mm")
    for name in CBCT_FIT_FIELDS:
        if data[name] > cpu_data[name] + MM_TOL:
            raise RuntimeError(f"WL from CBCT {name}: the card's {data[name]} exceeds the "
                               f"CPU's {cpu_data[name]}")
    print("WL from CBCT 3D isocentre fits: BB and field centres within "
          f"{PX_TOL} px of the CPU's; " + ", ".join(
              f"{name} card {data[name]:.6f} mm, CPU {cpu_data[name]:.6f} mm"
              for name in CBCT_FIT_FIELDS)
          + "; each twice its point's largest ray distance")


def wl_cbct_phase(card: str, ccl) -> list[dict]:
    """Winston-Lutz from a JPEG-LS CBCT zip: ``WinstonLutz.from_cbct_zip``
    (host projections), then ``analyze(bb_size_mm=5)`` on the card, which
    takes a low-density BB in an open field: no field fill, and the four
    views' BB windows scanned at 52 thresholds in one batched pass
    (``ccl.cu`` 4-connected, label and holes), counted with every input
    held to its twin; the bars, card against CPU, warm runs equal; the
    projection build and the analyze timed apart; a profile with the
    hull's range. Returns the CCL kernel's two lines."""
    from pylinac_tpu_torch import WinstonLutz
    from pylinac_tpu_torch.core import dcm
    from pylinac_tpu_torch.imggen.ct import _generate_cbct_bb
    from pylinac_tpu_torch.ops import label as tlabel

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cbct_")
    try:
        t0 = time.perf_counter()
        _generate_cbct_bb(f"{tmp}/cbct", num_slices=CBCT_SLICES, image_size=CBCT_SIZE,
                          transfer_syntax=dcm.JPEG_LS_LOSSLESS)
        zipped = zip_folder(f"{tmp}/cbct", f"{tmp}/cbct.zip")
        print(f"inputs: a CBCT of {CBCT_SLICES} slices of {CBCT_SIZE} x {CBCT_SIZE} uint16 as "
              f"JPEG-LS, zipped "
              f"{os.path.getsize(zipped) / 2**20:.1f} MiB, in {time.perf_counter() - t0:.1f} s")

        def run(device="cuda"):
            wl = WinstonLutz.from_cbct_zip(zipped)
            wl.analyze(bb_size_mm=5, device=device)
            return wl, wl.results_data(as_dict=True)

        (wl, data), counts, seen, errs = counted_ccl(ccl, run, "WL from CBCT")
        check_cbct_results(wl, data, "card WL from CBCT")
        t0 = time.perf_counter()
        cpu_wl, cpu_data = run("cpu")
        cpu_s = time.perf_counter() - t0
        for got, want in zip(wl.images, cpu_wl.images):
            if not np.array_equal(got.array, want.array):
                raise RuntimeError("the card run's projections differ from the CPU run's")
        worst = compare_tree({k: v for k, v in cpu_data.items() if k not in CBCT_FIT_FIELDS},
                             {k: v for k, v in data.items() if k not in CBCT_FIT_FIELDS},
                             "WL from CBCT CPU vs card", wl_tol)
        same_warnings(data, cpu_data, "WL from CBCT")
        print(f"WL from CBCT card vs CPU (the CPU run {cpu_s:.1f} s): agree in every field but "
              f"the 3D isocentre fits (max difference {worst:.2e})")
        check_cbct_fits(wl, cpu_wl, data, cpu_data)

        build_ms, wls = median_runs(card, f"WinstonLutz.from_cbct_zip projection build of "
                                    f"{CBCT_SLICES} JPEG-LS slices",
                                    lambda: WinstonLutz.from_cbct_zip(zipped), CBCT_WARM_RUNS)

        def analyze():
            fresh = wls.pop()
            fresh.analyze(bb_size_mm=5, device="cuda")
            out = fresh.results_data()
            torch.cuda.synchronize()
            return out

        analyze_ms, outs = median_runs(card, "WL from CBCT analyze + results_data of 4 views",
                                       analyze, CBCT_WARM_RUNS)
        check_same_texts([results_text(o) for o in outs], "WL from CBCT warm runs")
        print(f"[{card}] WL from CBCT: projection build {build_ms:.1f} ms, analyze "
              f"{analyze_ms:.1f} ms")

        hull = tlabel._hull_area

        def named_hull(*args, **kwargs):
            with torch.profiler.record_function("hull_area"):
                return hull(*args, **kwargs)

        profiled = WinstonLutz.from_cbct_zip(zipped)
        tlabel._hull_area = named_hull
        try:
            device_profile(card, "WL from CBCT analyze",
                           lambda: (profiled.analyze(bb_size_mm=5, device="cuda"),
                                    torch.cuda.synchronize()), analyze_ms, top=12,
                           ranges=("hull_area",))
        finally:
            tlabel._hull_area = hull

        label4 = (functools.partial(ccl.label_batch, connectivity=1),
                  functools.partial(ccl.label_reference, connectivity=1))
        lines = []
        for mode, kernel_twin in (("label", label4),
                                  ("holes", (ccl.hole_roots_batch, ccl.hole_roots_reference))):
            masks = largest_record(seen, mode)[0]
            masks = masks if masks.dim() == 3 else masks[None]
            lines.append(ccl_line(
                f"ccl_{mode}4_wl_cbct", "pylinac_tpu/ops/pallas_label.py:336", counts[mode],
                errs.get(mode, 0.0),
                timed_pair(card, f"WL from CBCT ccl {mode} 4-conn on the BB windows",
                           *kernel_twin, masks, ccl_bound)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


MTMF_AXES = ((0, 0, 0), (45, 0, 0), (135, 0, 0), (180, 0, 0), (225, 0, 0), (315, 0, 0),
             (0, 0, 45), (0, 0, 315))   # set C: at gantry 90 two fields merge
MTMF_CPU_FRAMES = (0, 3)  # the 2 frames held against the CPU: gantry 0 and 45
# 1 warm-up, then the median of 3: a warm 8-frame run takes about 12 s, and
# the smoke keeps to its time budget as phases are added
MTMF_WARM_RUNS = 3        # 1 + 2: a warm 8-frame run takes about 12 s


def write_mtmf_session(d: str, bb_left_mm: float = 0.0) -> str:
    """Write the SNC MultiMet session into ``d``: 6 BBs of 5 mm in 6 fields
    of 20 mm, AS1200 at SID 1000, 1 mm blur, set C's 8 frames; every BB
    ``bb_left_mm`` left of its field. Returns ``d``."""
    import dataclasses

    from pylinac_tpu_torch import BBArrangement
    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
    from pylinac_tpu_torch.imggen.simulators import AS1200Image
    from pylinac_tpu_torch.imggen.utils import generate_winstonlutz_multi_bb_multi_field

    bbs = BBArrangement.SNC_MULTIMET
    generate_winstonlutz_multi_bb_multi_field(
        AS1200Image(sid=1000), PerfectFieldLayer, d,
        field_offsets=[(b.offset_left_mm, b.offset_up_mm, b.offset_in_mm) for b in bbs],
        bb_offsets=[{**dataclasses.asdict(b), "offset_left_mm": b.offset_left_mm + bb_left_mm}
                    for b in bbs],
        image_axes=MTMF_AXES, final_layers=[GaussianFilterLayer(sigma_mm=1)])
    return d


def check_mtmf_results(wl, data: dict, what: str, offset_mm: float) -> None:
    """Every BB matched in every frame; ``tests/models/test_winstonlutz.py``
    ``TestMultiTargetMultiField``'s bars: the largest field-BB distance
    below 0.3 mm and no shift (within 0.1 mm and 0.1 deg) for the perfect
    set, 1.0 +- 0.3 mm and an x shift of 1.0 +- 0.3 mm for the 1 mm one."""
    sv = data["bb_shift_vector"]
    angles = [data["bb_shift_yaw"], data["bb_shift_pitch"], data["bb_shift_roll"]]
    checks = {"6 BBs in each of 8 frames": len(wl.images) == len(MTMF_AXES) and all(
        len(img.arrangement_matches) == 6 for img in wl.images) and len(data["bb_maxes"]) == 6}
    if offset_mm:
        checks["max 1.0 +- 0.3 mm"] = abs(data["max_2d_field_to_bb_mm"] - offset_mm) < 0.3
        checks["|shift x| 1.0 +- 0.3 mm"] = abs(abs(sv["x"]) - offset_mm) < 0.3
    else:
        checks["max < 0.3 mm"] = data["max_2d_field_to_bb_mm"] < 0.3
        checks["shift within 0.1 mm"] = all(abs(v) < 0.1 for v in sv.values())
        checks["rotations within 0.1 deg"] = all(abs(a) < 0.1 for a in angles)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{what} fails {failed}: {data}")
    print(f"{what}: max field-BB {data['max_2d_field_to_bb_mm']:.4f} mm, shift "
          f"({sv['x']:.4f}, {sv['y']:.4f}, {sv['z']:.4f}) mm, yaw/pitch/roll "
          f"{', '.join(f'{a:.4f}' for a in angles)} deg: inside every bar")


def mtmf_matches(wl) -> list[dict]:
    """Each image's matched BB and field points (px) by BB name."""
    return [{name: [m.field.x, m.field.y, m.bb.x, m.bb.y]
             for name, m in img.arrangement_matches.items()} for img in wl.images]


def mtmf_phase(card: str, ccl) -> list[dict]:
    """The multi-target Winston-Lutz path: the SNC MultiMet session (set C,
    8 AS1200 frames) through ``WinstonLutzMultiTargetMultiField`` on the
    card with every CCL input recorded and held to its twin (the largest
    whole-frame mask ten more launches, equal), the results against the
    reference's bars, a 1 mm offset copy, 2 frames against the CPU, the
    warm wall (every run's results equal) and a profile of the 2-frame run
    with the hull's device time. Returns the kernels-line entries: the field locator's
    8-connected labels and their holes, the BB windows' 4-connected labels
    and their holes."""
    from pylinac_tpu_torch import BBArrangement, WinstonLutzMultiTargetMultiField
    from pylinac_tpu_torch.ops import label as tlabel

    pairs = kernel_pairs(ccl)
    arrangement = BBArrangement.SNC_MULTIMET

    def analyze(wl, device="cuda"):
        def run():
            wl.analyze(arrangement, device=device)
            return wl.results_data()
        return run

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mtmf_")
    try:
        t0 = time.perf_counter()
        session = write_mtmf_session(f"{tmp}/setc")
        offset_session = write_mtmf_session(f"{tmp}/setc_1mm", bb_left_mm=1.0)
        wl = WinstonLutzMultiTargetMultiField(session)
        print(f"inputs: 2 x {len(wl.images)} MTMF frames {wl.images[0].shape} "
              f"{wl.images[0].array.dtype} in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

        for counter in (ccl.label_batch, ccl.hole_roots_batch):
            counter.launches = 0
        with recording_inputs(ccl_entries()) as seen:
            result = analyze(wl)()
        torch.cuda.synchronize()
        counts = {"label": ccl.label_batch.launches, "holes": ccl.hole_roots_batch.launches}
        check_counts(seen, counts, "MTMF run")
        # split the records into the field locator's whole frames and the BB
        # windows: a window's holes call follows its 4-connected label call
        kinds, last = [], None
        for mode, masks, args, _ in seen:
            if mode == "label":
                last = "field" if args[0] == 2 else "window"
            kinds.append(last)
        split = {(mode, kind): [r for r, k in zip(seen, kinds) if r[0] == mode and k == kind]
                 for mode in ("label", "holes") for kind in ("field", "window")}
        launches = {key: len(records) for key, records in split.items()}
        if min(launches.values()) < 1:
            raise RuntimeError(f"the MTMF path launched a CCL mode no time: {launches}")
        if any(r[1].shape[-2:] != wl.images[0].shape for r in split["label", "field"]):
            raise RuntimeError("a field-locator mask is not a whole frame")
        errs = {key: check_path_masks(pairs, records, f"MTMF {key[1]} {key[0]}")[key[0]]
                for key, records in split.items()}
        big, big_args, _ = max(((m, a, k) for _, m, a, k in split["label", "field"]),
                               key=lambda r: int(r[0].sum()))
        big = big if big.dim() == 3 else big[None]
        for mode, fn, args in (("label", ccl.label_batch, big_args),
                               ("holes", ccl.hole_roots_batch, ())):
            first = fn(big, *args)
            if not all(torch.equal(fn(big, *args), first) for _ in range(REPEATS)):
                raise RuntimeError(f"{mode} changed between launches on the largest field mask")
        print(f"MTMF path: launches {launches}; the largest whole-frame mask "
              f"({int(big.sum())} px set) gives the same labels and holes in {REPEATS} more "
              f"launches")
        data = json.loads(result.model_dump_json())
        check_mtmf_results(wl, data, "card MTMF, set C", 0.0)
        print(f"MTMF counted run and its kernel checks: {time.perf_counter() - t0:.1f} s "
              f"since the session was written")

        offset = WinstonLutzMultiTargetMultiField(offset_session)
        check_mtmf_results(offset, json.loads(analyze(offset)().model_dump_json()),
                           "card MTMF, every BB 1 mm left", 1.0)

        files = [str(wl.images[i].path) for i in MTMF_CPU_FRAMES]
        t0 = time.perf_counter()
        cpu = WinstonLutzMultiTargetMultiField(files)
        cpu_data = json.loads(analyze(cpu, "cpu")().model_dump_json())
        cpu_s = time.perf_counter() - t0
        card2 = WinstonLutzMultiTargetMultiField(files)
        worst = compare_tree(json.loads(analyze(card2)().model_dump_json()), cpu_data,
                             "MTMF CPU vs card, 2 frames", wl_tol)
        full = mtmf_matches(wl)
        for got, want in ((mtmf_matches(card2), mtmf_matches(cpu)),
                          ([full[i] for i in MTMF_CPU_FRAMES], mtmf_matches(cpu))):
            for a, b in zip(got, want):
                if list(a) != list(b) or max(abs(x - y) for k in a for x, y in
                                             zip(a[k], b[k])) > PX_TOL:
                    raise RuntimeError(f"MTMF matches differ from the CPU: {a} vs {b}")
        print(f"MTMF card vs CPU on frames {MTMF_CPU_FRAMES} (the CPU run {cpu_s:.1f} s): "
              f"results agree (max difference {worst:.2e}), every matched field and BB "
              f"within {PX_TOL} px, in the 2-frame and the 8-frame card runs")

        texts, times = [], []
        for _ in range(MTMF_WARM_RUNS):
            t0 = time.perf_counter()
            texts.append(results_text(analyze(wl)()))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        check_same_texts(texts, "MTMF warm runs")
        t0 = time.perf_counter()
        warm = statistics.median(times[1:])
        print(f"[{card}] warm WinstonLutzMultiTargetMultiField analyze + results_data of "
              f"{len(wl.images)} frames: median {warm:.1f} ms of {MTMF_WARM_RUNS - 1} runs = "
              f"{len(wl.images) / warm * 1e3:.2f} images/s "
              f"(runs ms: {', '.join(f'{t:.1f}' for t in times[1:])})")

        # the profile takes the 2-frame run (frames 0 and 3): the profiler
        # took 130 s to process an 8-frame run's 177,000 launches
        two = []
        for _ in range(3):
            t1 = time.perf_counter()
            analyze(card2)()
            torch.cuda.synchronize()
            two.append((time.perf_counter() - t1) * 1e3)
        two_ms = statistics.median(two[1:])
        print(f"[{card}] warm MTMF analyze + results_data of frames {MTMF_CPU_FRAMES}: "
              f"median {two_ms:.1f} ms of 2 runs")
        hull = tlabel._hull_area

        def named_hull(*args, **kwargs):
            with torch.profiler.record_function("hull_area"):
                return hull(*args, **kwargs)

        tlabel._hull_area = named_hull
        try:
            device_profile(card, f"MTMF, frames {MTMF_CPU_FRAMES}", analyze(card2), two_ms,
                           top=15, ranges=("hull_area",))
        finally:
            tlabel._hull_area = hull
        print(f"MTMF profile, with its processing: {time.perf_counter() - t0:.1f} s")

        label8 = (functools.partial(ccl.label_batch, connectivity=2),
                  functools.partial(ccl.label_reference, connectivity=2))
        label4 = (functools.partial(ccl.label_batch, connectivity=1),
                  functools.partial(ccl.label_reference, connectivity=1))
        holes = (ccl.hole_roots_batch, ccl.hole_roots_reference)
        lines = []
        for name, key, kernel_twin, replaces, where in (
                ("ccl_label8_mtmf_fields", ("label", "field"), label8,
                 "pylinac_tpu/ops/pallas_label.py:69", "8-conn on the largest field mask"),
                ("ccl_holes_mtmf_fields", ("holes", "field"), holes,
                 "pylinac_tpu/ops/pallas_label.py:232", "on the largest field mask"),
                ("ccl_label4_mtmf_bb_windows", ("label", "window"), label4,
                 "pylinac_tpu/ops/pallas_label.py:69", "4-conn on the largest BB window"),
                ("ccl_holes_mtmf_bb_windows", ("holes", "window"), holes,
                 "pylinac_tpu/ops/pallas_label.py:232", "on the largest BB window")):
            masks = max((m for _, m, *_ in split[key]), key=lambda m: int(m.sum()))
            masks = masks if masks.dim() == 3 else masks[None]
            lines.append(ccl_line(name, replaces, launches[key], errs[key],
                                  timed_pair(card, f"MTMF ccl {key[0]} {where}", *kernel_twin,
                                             masks, ccl_bound)))
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


# the bench's Starshot (bench.py:314-352): 16 stars of 1000 x 1040 uint16,
# dpi 100, SID 1000, 5 spokes through (500, 520), offsets 10 + i degrees
STAR_IMAGES, STAR_CENTRE = 16, (500.0, 520.0)
STAR_DIAM_MM = 0.01       # bench.py:349: the wobble of a perfect star
STAR_DEG = 1e-3           # card against CPU, degrees
STAR_SINGLE = dict(mm=0.05, px=1.0, deg=1.0)   # tests/models/test_starshot_batch.py:41-55
STAR_SINGLE_TRUTH_PX = 0.1
# the single PicketFence against PicketFenceBatch on one frame, at
# tests/models/test_picketfence_batch.py:27-46's bars; the offsets are held
# to the batch's plus the shift the single class's kiss windows predict
# (pf_window_shift_mm), which
# tests/test_torch_picketfence_single.py::test_single_offsets_sit_half_a_pixel_from_the_batch
# pins in the JAX package and the port on these same frames
PF_SINGLE_TOL = 1e-3
PF_SINGLE_OFFSET_MM = 2e-3


def make_stars(tmp: str) -> list[str]:
    """The bench's 16 stars, then a wobbly one (3 px shifts), one whose
    half spoke fails the first combos of the retry ladder, and a film-like
    one (dark spokes) that trips the inversion check, all of the bench's
    size."""
    from pylinac_tpu_torch.imggen.utils import make_starshot

    specs = [dict(angles_offset=10.0 + i) for i in range(STAR_IMAGES)]
    specs += [dict(wobble_shift_px=3.0), dict(angles_offset=12.0, half_spoke=0.5),
              dict(angles_offset=14.0, invert=True, noise=20.0)]
    return [make_starshot(tmp, n_spokes=5, name=f"star{i}.dcm", **spec)
            for i, spec in enumerate(specs)]


def star_tol(path: str, a: float) -> float:
    if path.endswith("_mm"):
        return MM_TOL
    return STAR_DEG if path.startswith("/angles") else PX_TOL


def check_star_bench(results, dpmm: float, out: dict) -> None:
    """bench.py:341-352: every centre within 0.01 * dpmm px of the drawn
    one, every diameter below 0.01 mm; 5 lines and found."""
    worst_c = max(max(abs(r.circle_center_x_y[0] - STAR_CENTRE[0]),
                      abs(r.circle_center_x_y[1] - STAR_CENTRE[1])) for r in results)
    worst_d = max(r.circle_diameter_mm for r in results)
    if worst_c >= 0.01 * dpmm or worst_d >= STAR_DIAM_MM:
        raise RuntimeError(f"starshot bench bars: centre off by up to {worst_c} px "
                           f"(bar {0.01 * dpmm}), diameter up to {worst_d} mm")
    if not out["found"].all() or (out["n_lines"] != 5).any() or (out["combos_tried"] != 1).any():
        raise RuntimeError(f"starshot: found {out['found']}, lines {out['n_lines']}, "
                           f"combos {out['combos_tried']}")
    print(f"starshot bench bars: {len(results)} stars, centre within {worst_c:.6f} px "
          f"(bar {0.01 * dpmm:.4f}), diameter up to {worst_d:.6f} mm (bar {STAR_DIAM_MM}), "
          f"5 lines and one combo each")


def compare_star_outputs(a: dict, b: dict, what: str) -> float:
    """The pipeline's outputs on two devices: integers and flags exact, the
    px fields finite in the same places and within PX_TOL where they are;
    returns the largest px difference."""
    worst = 0.0
    for key, x in a.items():
        y = b[key]
        if x.dtype.kind in "biu" or key == "start_point":
            if not np.array_equal(x, y):
                raise RuntimeError(f"{what}: {key} differs: {x} against {y}")
            continue
        finite = np.isfinite(x)
        if not np.array_equal(finite, np.isfinite(y)):
            raise RuntimeError(f"{what}: {key} is finite in other places: {x} against {y}")
        d = float(np.max(np.abs(x[finite] - y[finite]), initial=0.0))
        if not d <= PX_TOL:
            raise RuntimeError(f"{what}: {key} differs by {d} px")
        worst = max(worst, d)
    return worst


def time_nm(card: str, out: dict) -> None:
    """The batched Nelder-Mead of the run's lines on the card and on CPU
    tensors, timed alike (median of 5 after a warm-up), and their results
    compared."""
    from pylinac_tpu_torch.ops.optimize import nelder_mead_batch
    from pylinac_tpu_torch.ops.star_pipeline import _max_distance

    results = {}
    for where in ("cuda", "cpu"):
        p1 = torch.from_numpy(out["line_p1"]).to(where)
        p2 = torch.from_numpy(out["line_p2"]).to(where)
        valid = torch.from_numpy(out["line_valid"]).to(where)
        x0 = torch.from_numpy(out["start_point"]).to(where)
        d = p2 - p1
        d = d / torch.clamp(torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]),
                            min=1e-9)[..., None]
        f = _max_distance(p1, d, valid)
        times = []
        for _ in range(6):
            synchronize(where)
            t0 = time.perf_counter()
            x, fx = nelder_mead_batch(f, x0, fatol=0.001, xatol=1e-4, max_iter=400)
            synchronize(where)
            times.append((time.perf_counter() - t0) * 1e3)
        results[where] = (x.cpu(), fx.cpu(), statistics.median(times[1:]))
    same = (torch.equal(results["cuda"][0], results["cpu"][0])
            and torch.equal(results["cuda"][1], results["cpu"][1]))
    print(f"[{card}] starshot Nelder-Mead of {x0.shape[0]} problems: on the card "
          f"{results['cuda'][2]:.3f} ms, on CPU tensors {results['cpu'][2]:.3f} ms (median of 5); "
          f"results {'bit-equal' if same else 'differ'}")


def time_fits_on_card(card: str, batch) -> None:
    """The warm batch end to end with its minimax fits on the card in place
    of CPU tensors (``ops/star_pipeline.FIT_DEVICE`` set to ``cuda``),
    against the shipped placement, in turns (host, card, card, host; median
    of 3 runs each); the results must be the same."""
    from pylinac_tpu_torch.ops import star_pipeline

    shipped = star_pipeline.FIT_DEVICE
    walls = {"host": [], "card": []}
    texts = {}
    for where in ("host", "card", "card", "host"):
        star_pipeline.FIT_DEVICE = shipped if where == "host" else "cuda"
        try:
            for _ in range(3):
                t0 = time.perf_counter()
                batch.analyze(device="cuda")
                texts[where] = results_text(batch.results_data())
                torch.cuda.synchronize()
                walls[where].append((time.perf_counter() - t0) * 1e3)
        finally:
            star_pipeline.FIT_DEVICE = shipped
    if texts["host"] != texts["card"]:
        raise RuntimeError("the starshot results differ with the fits on the card")
    print(f"[{card}] warm StarshotBatch with its minimax fits on CPU tensors (shipped) "
          f"{statistics.median(walls['host']):.3f} ms, on the card "
          f"{statistics.median(walls['card']):.3f} ms (median of 6 runs each, in turns); "
          f"results equal")


def synchronize(where: str) -> None:
    if torch.device(where).type == "cuda":
        torch.cuda.synchronize()


def starshot_phase(card: str) -> None:
    """The Starshot path: the bench's 16 stars through ``StarshotBatch`` on
    the card against the bench's bars and the CPU run; a wobbly, a
    ladder-climbing and a film-like star on the card against the CPU; every
    warm run equal to the first; images/s, a profile, the Nelder-Mead on
    the card and on CPU tensors; the single-image ``Starshot`` against the
    batch and the drawn centre. No kernel of the port runs on this path."""
    from pylinac_tpu_torch import Starshot, StarshotBatch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_star_")
    try:
        t0 = time.perf_counter()
        paths = make_stars(tmp)
        bench, extra = paths[:STAR_IMAGES], paths[STAR_IMAGES:]
        batch = StarshotBatch(bench)
        dpmm = float(batch.images[0].dpmm)
        print(f"inputs: {len(paths)} stars {batch.images[0].shape} "
              f"{batch.images[0].array.dtype}, dpmm {dpmm:.4f}, in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        batch.analyze(device="cuda")
        results = batch.results_data()
        torch.cuda.synchronize()
        print(f"starshot batch, first run (staging included): "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        check_star_bench(results, dpmm, batch._out)

        cpu = StarshotBatch(bench)
        cpu.analyze(device="cpu")
        px = compare_star_outputs(batch._out, cpu._out, "starshot card vs CPU")
        tree = compare_tree(json.loads(results_text(results[0])),
                            json.loads(results_text(cpu.results_data()[0])), "star", star_tol)
        for r, c in zip(results[1:], cpu.results_data()[1:]):
            tree = max(tree, compare_tree(json.loads(results_text(r)),
                                          json.loads(results_text(c)), "star", star_tol))
        print(f"starshot card vs CPU, {STAR_IMAGES} stars: outputs within {px:.2e} px, "
              f"results_data within {tree:.2e} (mm {MM_TOL}, px {PX_TOL}, degrees {STAR_DEG})")

        more = StarshotBatch(extra)
        more.analyze(device="cuda")
        more_cpu = StarshotBatch(extra)
        more_cpu.analyze(device="cpu")
        px = compare_star_outputs(more._out, more_cpu._out, "starshot extra stars card vs CPU")
        wob, ladder, film = more.results_data()
        tried = more._out["combos_tried"].tolist()
        if not 0.2 < wob.circle_diameter_mm < 2.0:
            raise RuntimeError(f"wobbly star: diameter {wob.circle_diameter_mm} mm")
        if tried[1] <= 1:
            raise RuntimeError(f"the ladder star took {tried[1]} combos on the card")
        arr = np.asarray(more.images[2].array, np.float64)
        p4, p50, p96 = np.percentile(arr, [4, 50, 96])
        if not abs(p50 - p4) > abs(p50 - p96):
            raise RuntimeError("the film-like star does not trip the inversion check")
        for r, name in ((ladder, "ladder"), (film, "film-like")):
            off = max(abs(r.circle_center_x_y[0] - STAR_CENTRE[0]),
                      abs(r.circle_center_x_y[1] - STAR_CENTRE[1]))
            if off > 0.1 or r.circle_diameter_mm > 0.05:
                raise RuntimeError(f"{name} star: centre off by {off} px, "
                                   f"diameter {r.circle_diameter_mm} mm")
        print(f"starshot extra stars on the card, equal to the CPU within {px:.2e} px: wobbly "
              f"{wob.circle_diameter_mm:.4f} mm, ladder {tried[1]} combos, film-like inverted, "
              f"combos {tried}")

        times, texts = [], []
        for _ in range(6):
            t0 = time.perf_counter()
            batch.analyze(device="cuda")
            texts.append(results_text(batch.results_data()))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        warm = statistics.median(times[1:])
        check_same_texts(texts, "StarshotBatch")
        print(f"[{card}] warm StarshotBatch analyze + results_data of {STAR_IMAGES} stars: "
              f"median {warm * 1e3:.3f} ms of 5 runs = {STAR_IMAGES / warm:.1f} images/s "
              f"(runs ms: {', '.join(f'{t * 1e3:.3f}' for t in times[1:])})")
        device_profile(card, "StarshotBatch", lambda: (
            batch.analyze(device="cuda"), batch.results_data(), torch.cuda.synchronize()),
            warm * 1e3, top=12)
        time_nm(card, batch._out)
        time_fits_on_card(card, batch)
        pr = cProfile.Profile()
        pr.enable()
        t0 = time.perf_counter()
        batch.analyze(device="cuda")
        batch.results_data()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        pr.disable()
        out = io.StringIO()
        pstats.Stats(pr, stream=out).sort_stats("cumulative").print_stats(12)
        print(f"[{card}] StarshotBatch cProfile run wall {wall:.3f} ms (by cumulative time)")
        print(out.getvalue())

        t0 = time.perf_counter()
        single = Starshot(bench[0])
        single.analyze()
        sr = single.results_data()
        single_ms = (time.perf_counter() - t0) * 1e3
        br = results[0]
        if (abs(sr.circle_diameter_mm - br.circle_diameter_mm) > STAR_SINGLE["mm"]
                or max(abs(a - b) for a, b in zip(sr.circle_center_x_y, br.circle_center_x_y))
                > STAR_SINGLE["px"] or len(sr.angles) != len(br.angles)
                or not np.allclose(sorted(sr.angles), sorted(br.angles), atol=STAR_SINGLE["deg"])):
            raise RuntimeError(f"single Starshot {sr} against the batch's {br}")
        off = max(abs(sr.circle_center_x_y[0] - STAR_CENTRE[0]),
                  abs(sr.circle_center_x_y[1] - STAR_CENTRE[1]))
        if off > STAR_SINGLE_TRUTH_PX:
            raise RuntimeError(f"single Starshot centre {sr.circle_center_x_y} off the drawn "
                               f"{STAR_CENTRE} by {off} px")
        print(f"[{card}] single Starshot on star 0 (host numpy, Nelder-Mead on CPU tensors): "
              f"{single_ms:.1f} ms; centre ({sr.circle_center_x_y[0]:.4f}, "
              f"{sr.circle_center_x_y[1]:.4f}), {off:.4f} px from the drawn; diameter "
              f"{sr.circle_diameter_mm:.5f} mm; against the batch within the bars {STAR_SINGLE}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def make_pf_singles(tmp: str) -> list[str]:
    """Two uncropped AS1200 picket fence frames (the smoke's generator,
    the second with picket 3 moved by 0.4 mm) through the smoke's EPID
    recipe, written as DICOM: they trip the single image's de-spike."""
    from pylinac_tpu_torch.core import image as timage
    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
    from pylinac_tpu_torch.imggen.simulators import AS1200Image
    from pylinac_tpu_torch.imggen.utils import generate_picketfence

    paths = []
    rng = np.random.default_rng(11)
    for i, offset in enumerate((0.0, OFFSET_MM)):
        err = [0.0] * 10
        err[2] = offset
        raw = f"{tmp}/raw{i}.dcm"
        generate_picketfence(
            simulator=AS1200Image(sid=1500), field_layer=PerfectFieldLayer, file_out=raw,
            final_layers=[GaussianFilterLayer(sigma_mm=1)], pickets=10,
            picket_spacing_mm=20, picket_width_mm=3, picket_offset_error=err)
        img = timage.DicomImage(raw)
        a = img.array
        noisy = a.astype(np.float64) * 0.5 + 1000 + rng.normal(0, 2, a.shape).round()
        noisy = np.clip(noisy, 0, 65535)
        noisy.flat[rng.choice(a.size, a.size // 10000, replace=False)] = 65535
        img.array = noisy.astype(np.uint16)
        paths.append(img.save(f"{tmp}/spiked{i}.dcm"))
    return paths


def pf_window_shift_mm(pf) -> np.ndarray:
    """Each picket's offset from the CAX less the batch's, as the single
    class's kiss windows predict it (a reference quirk kept for parity):
    they start at ``int(v)`` for ``v = idx - spacing / 2`` (clamped at 0)
    but add ``v`` to the crossings, so the picket sits ``frac(v)`` px
    further from the image's start and its ``dist2cax`` (centre minus
    picket) ``frac(v) / dpmm`` lower."""
    out = []
    for pk in pf.pickets:
        v = max(pk.mlc_meas[0]._approximate_idx - pk.mlc_meas[0]._spacing / 2, 0)
        out.append(-(v - int(v)) / pf.image.dpmm)
    return np.asarray(out)


def pf_single_phase(card: str, median) -> tuple[int, float]:
    """The single-image ``PicketFence`` on two spiked frames on the card:
    its de-spike's median3x3 launches counted and each input held bit-equal
    to the twin, the results against the CPU run, ``PicketFenceBatch`` on
    the same frames and the drawn geometry; timed. Returns the launches and
    the kernel's largest error against its twin."""
    from pylinac_tpu_torch import PicketFence, PicketFenceBatch
    from pylinac_tpu_torch.ops import filters as tfilters

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pf1_")
    try:
        paths = make_pf_singles(tmp)
        median.median3x3.launches = 0
        with recording_inputs([(tfilters, "median3x3", "median")]) as seen:
            t0 = time.perf_counter()
            singles, shifts = [], []
            for path in paths:
                pf = PicketFence(path, device="cuda")
                pf.analyze(tolerance=0.5)
                singles.append(pf.results_data())
                shifts.append(pf_window_shift_mm(pf))
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = median.median3x3.launches
        if launches < 1:
            raise RuntimeError("the single PicketFence launched no median3x3 kernel")
        check_counts(seen, {"median": launches}, "single PicketFence")
        worst = check_path_masks({"median": (median.median3x3, median.median3x3_reference)},
                                 seen, "single PicketFence")["median"]
        frame = seen[0][1].to(torch.float32)
        kernel_ms, plain_ms = time_pair(median.median3x3, median.median3x3_reference,
                                        frame, 50, 5)
        bound_ms, bound_by = bound(8 * frame.numel(), 21 * frame.numel(), F32_INSTR_PER_S)
        print(f"[{card}] median3x3 at {tuple(frame.shape)}, the single frame's de-spike: "
              f"kernel {kernel_ms:.4f} ms, plain twin {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        print(f"single PicketFence on {len(paths)} spiked frames: median3x3.launches = "
              f"{launches} (de-spike inputs {[tuple(x.shape) for _, x, *_ in seen]}), "
              f"{first_ms:.1f} ms")

        cpu = []
        for path in paths:
            pf = PicketFence(path, device="cpu")
            pf.analyze(tolerance=0.5)
            cpu.append(pf.results_data())
        mm = compare(singles, cpu)
        print(f"single PicketFence card vs CPU: agree (max mm difference {mm:.2e})")

        batch = PicketFenceBatch(paths)
        batch.analyze(tolerance=0.5, device="cuda")
        worst_b = 0.0
        for i, (s, b) in enumerate(zip(singles, batch.results_data())):
            if s.number_of_pickets != b.number_of_pickets or s.failed_leaves != b.failed_leaves \
                    or sorted(s.mlc_errors_by_leaf) != sorted(b.mlc_errors_by_leaf):
                raise RuntimeError(f"frame {i}: single and batch differ in pickets or leaves")
            if abs(s.percent_leaves_passing - b.percent_leaves_passing) > 1e-9:
                raise RuntimeError(f"frame {i}: percent passing differs from the batch")
            for name in ("max_error_mm", "absolute_median_error_mm", "mean_picket_spacing_mm",
                         "mlc_skew"):
                d = abs(getattr(s, name) - getattr(b, name))
                worst_b = max(worst_b, d)
                if d > PF_SINGLE_TOL:
                    raise RuntimeError(f"frame {i}: {name} differs from the batch by {d}")
            gap = np.subtract(s.offsets_from_cax_mm, b.offsets_from_cax_mm)
            d = float(np.max(np.abs(gap - shifts[i])))
            if not d <= PF_SINGLE_OFFSET_MM:
                raise RuntimeError(f"frame {i}: offsets differ from the batch's by {gap} mm, "
                                   f"{d} mm off the window shift {shifts[i]}")
            print(f"single PicketFence frame {i} against PicketFenceBatch: fields within "
                  f"{worst_b:.2e}, offsets {gap.min():.6f} to {gap.max():.6f} mm from the "
                  f"batch's, within {d:.2e} mm of the window shift "
                  f"({shifts[i].min():.6f} to {shifts[i].max():.6f} mm)")
        shift = abs(singles[1].offsets_from_cax_mm[2] - singles[0].offsets_from_cax_mm[2])
        if any(s.number_of_pickets != 10 for s in singles) or abs(shift - OFFSET_MM) > 0.05:
            raise RuntimeError(f"single PicketFence: pickets "
                               f"{[s.number_of_pickets for s in singles]}, picket 3 shift {shift}")
        if not (singles[0].passed and singles[0].max_error_mm < 0.1):
            raise RuntimeError(f"perfect frame: max error {singles[0].max_error_mm} mm")
        print(f"single PicketFence drawn geometry: 10 pickets, picket 3 moved {shift:.4f} mm "
              f"(drawn {OFFSET_MM}), perfect frame max error {singles[0].max_error_mm:.6f} mm")

        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            pf = PicketFence(paths[0], device="cuda")
            pf.analyze(tolerance=0.5)
            pf.results_data()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"[{card}] single PicketFence (load, de-spike, analyze, results_data) of one "
              f"frame: median {statistics.median(times[1:]):.1f} ms of 5 runs "
              f"(runs ms: {', '.join(f'{t:.1f}' for t in times[1:])})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, worst


VMAT_TESTS = (("DRGS", "drgs", [0, 0, 3, 0, 0, 0, 0]), ("DRMLC", "drmlc", [0, 0, 0, 3]),
              ("DRCS", "drcs", [0, 3, 0, 0, 0]))   # each pair with one segment 3 % hot
DLG_GAPS = (-0.4, -0.6, -0.8, -1.0, -1.2)
DLG_TOL_MM = 0.15         # tests/models/test_quart_dlg.py:131
QUART_SLICES = 60
QUART_ROLL_DEG = 2.0
QUART_HU = {"Air": -1000, "Poly": -35, "Acrylic": 120, "Teflon": 990, "Water": 0}
QUART_HU_TOL = 15         # tests/models/test_quart_dlg.py:34-52
QUART_ROLL_TOL = 0.7      # tests/models/test_quart_dlg.py:90


def result_dict(obj) -> dict:
    """A VMAT or Quart result as its dict, without date and version."""
    data = obj.results_data(as_dict=True)
    data.pop("date_of_analysis")
    data.pop("pylinac_version")
    return data


def xim_payload(path: str):
    """The lookup table and diff buffer of a compressed .xim file."""
    import struct

    with open(path, "rb") as f:
        f.seek(8 + 6 * 4)
        lut = np.frombuffer(f.read(struct.unpack("<i", f.read(4))[0]), np.uint8)
        buf = np.frombuffer(f.read(struct.unpack("<i", f.read(4))[0]), np.uint8)
    return lut, buf


def vmat_phase(card: str) -> None:
    """DRGS, DRMLC and DRCS on AS1200 pairs (1280 x 1280 uint16, SID 1000),
    each with one segment drawn 3 % hot, on the card: the hot segment the
    one that fails, the card against the CPU, DRCS's size-10 median on the
    card against the CPU's; the DRGS pair also as .xim files, its results
    against the DICOM pair's, the native .xim decode against its numpy
    twin, both timed; each analysis timed, DRCS's profiled. This path
    launches no kernel of the port: the VMAT tests are host numpy but DRCS's
    median, which the general sort computes on the card."""
    from pylinac_tpu_torch import vmat
    from pylinac_tpu_torch import native
    from pylinac_tpu_torch.core import xim
    from pylinac_tpu_torch.core.image import XIM, load
    from pylinac_tpu_torch.imggen.simulators import AS1200Image
    from pylinac_tpu_torch.imggen.utils import _generate_vmat_pair
    from pylinac_tpu_torch.ops.filters import median_filter

    tmp = tempfile.mkdtemp(prefix="chip_smoke_vmat_")
    try:
        t0 = time.perf_counter()
        pairs = {test: _generate_vmat_pair(test, AS1200Image(sid=1000), tmp, errors)
                 for _, test, errors in VMAT_TESTS}
        print(f"inputs: 3 VMAT pairs of AS1200 frames (1280 x 1280 uint16) in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, test, errors in VMAT_TESTS:
            cls = getattr(vmat, name)

            def run(device="cuda"):
                obj = cls(image_paths=pairs[test], device=device)
                obj.analyze()
                data = result_dict(obj)
                if device == "cuda":
                    torch.cuda.synchronize()
                return data

            card_data = run()
            hot = errors.index(3)
            passed = [seg["passed"] for seg in card_data["segment_data"]]
            devs = [seg["r_dev"] for seg in card_data["segment_data"]]
            if card_data["passed"] or passed != [i != hot for i in range(len(passed))] \
                    or int(np.argmax(devs)) != hot or not 1.5 < devs[hot] < 3.5:
                raise RuntimeError(f"{name}: the 3 % hot segment {hot} is not the one that "
                                   f"fails: passed {passed}, deviations {devs}")
            if name == "DRCS":
                offsets = [c["angle_deviation"] for c in card_data["collimator_data"].values()]
                if sorted(card_data["collimator_data"]) != list("ABCDEF") \
                        or max(map(abs, offsets)) > 1.0:
                    raise RuntimeError(f"DRCS collimator spokes: {card_data['collimator_data']}")
            cpu_data = run("cpu")
            if json.dumps(card_data) != json.dumps(cpu_data):
                raise RuntimeError(f"{name}: the card's results differ from the CPU's")
            warm, outs = median_runs(card, f"{name} load + analyze + results_data of one "
                                     f"AS1200 pair", run)
            check_same_texts([json.dumps(o) for o in outs], f"{name} warm runs")
            if name == "DRCS":  # the only VMAT test with device work: its medians
                device_profile(card, "DRCS load + analyze + results_data", run, warm, top=8)
            print(f"{name}: segment {hot} drawn 3 % hot fails alone (deviations "
                  f"{', '.join(f'{d:.4f}' for d in devs)} %), card equal to the CPU bit for "
                  f"bit" + (f", collimator offsets {', '.join(f'{o:.3f}' for o in offsets)} deg"
                            if name == "DRCS" else ""))

        # DRCS's identification median: the general sort on the card and the CPU
        frame = torch.from_numpy(np.asarray(load(pairs["drcs"][0]).array, np.float32))
        on_card = median_filter(frame.cuda(), 10)
        if not torch.equal(on_card.cpu(), median_filter(frame, 10)):
            raise RuntimeError("DRCS: the card's size-10 median differs from the CPU's")
        card_ms = time_ms(lambda x: median_filter(x, 10), frame.cuda(), 5)
        print(f"[{card}] DRCS size-10 median of a {tuple(frame.shape)} frame on the card "
              f"(the general sort): {card_ms:.3f} ms, equal to the CPU's bit for bit")

        # the DRGS pair as .xim files: the same results as the DICOM pair
        xim_paths = []
        for path in pairs["drgs"]:
            arr = load(path).array
            out = path[:-4] + ".xim"
            xim.write_xim(out, arr, {"PixelWidth": 0.0336, "PixelHeight": 0.0336,
                                     "GantryRtn": 180.0, "MVCollimatorRtn": 180.0,
                                     "CouchRtn": 180.0})
            img = load(out)
            if not isinstance(img, XIM) or not np.array_equal(img.array, arr):
                raise RuntimeError(f"{out}: the .xim image does not load back as written")
            xim_paths.append(out)
        d_obj = vmat.DRGS(image_paths=pairs["drgs"], device="cuda")
        d_obj.analyze()
        x_obj = vmat.DRGS(image_paths=xim_paths, device="cuda")
        x_obj.analyze()
        # the .xim pixel size is 0.0336 cm, whose dpmm differs from the DICOM
        # pair's 1 / 0.336 in the last bit
        worst = compare_tree(result_dict(x_obj), result_dict(d_obj), "DRGS .xim vs DICOM pair",
                             wl_tol)
        print(f"DRGS from the .xim pair: results_data() agrees with the DICOM pair's (max "
              f"difference {worst:.2e}; flags, keys and strings equal)")
        lut, buf = xim_payload(xim_paths[1])
        decode = native.xim_decode_native()
        rc, pixels = decode(buf, lut, 1280, 1280)
        twin = xim._decode_numpy(buf, lut, 1280, 1280)
        if rc != 0 or not np.array_equal(pixels, twin):
            raise RuntimeError(f"native .xim decode (rc {rc}) differs from its numpy twin")
        times = {"native": [], "numpy": []}
        for which in ("numpy", "native", "native", "numpy"):
            for _ in range(3):
                t0 = time.perf_counter()
                decode(buf, lut, 1280, 1280) if which == "native" else \
                    xim._decode_numpy(buf, lut, 1280, 1280)
                times[which].append((time.perf_counter() - t0) * 1e3)
        print(f"[{card}] .xim decode of a 1280 x 1280 frame ({buf.nbytes} payload bytes) on the "
              f"host: native {statistics.median(times['native']):.2f} ms, numpy twin "
              f"{statistics.median(times['numpy']):.2f} ms (medians of 6), equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dlg_phase(card: str) -> None:
    """DLG of one AS1200 frame with five drawn gaps (-0.4 to -1.2 mm, the
    depth 300 |gap|, ``tests/models/test_quart_dlg.py:104-131``), against
    the drawn value 0 within 0.15 mm; host code, timed on this machine's
    CPU."""
    from pylinac_tpu_torch import DLG, MLC
    from pylinac_tpu_torch.imggen.simulators import AS1200Image
    from pylinac_tpu_torch.imggen.utils import _generate_dlg

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dlg_")
    try:
        path = os.path.join(tmp, "dlg.dcm")
        _generate_dlg(AS1200Image(sid=1000), path, DLG_GAPS)

        def run():
            dlg = DLG(path)
            dlg.analyze(gaps=DLG_GAPS, mlc=MLC.MILLENNIUM)
            return dlg

        warm, outs = median_runs(card, "DLG load + analyze of one AS1200 frame (host)", run)
        dlg = outs[0]
        if len(dlg.measured_dlg_per_leaf) < 10 or abs(dlg.measured_dlg) > DLG_TOL_MM:
            raise RuntimeError(f"DLG: {len(dlg.measured_dlg_per_leaf)} leaves, measured "
                               f"{dlg.measured_dlg} mm against the drawn 0")
        if any(o.measured_dlg_per_leaf != dlg.measured_dlg_per_leaf for o in outs):
            raise RuntimeError("DLG: runs disagree")
        print(f"DLG: {len(dlg.measured_dlg_per_leaf)} leaves, measured {dlg.measured_dlg:.5f} mm "
              f"(drawn 0, bar {DLG_TOL_MM}), every run equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_quart_results(data: dict, roll: float, what: str) -> None:
    """The generator's phantom: its HU inserts and uniform body within 15 HU,
    a 160 mm diameter within 2 mm, a sharp edge, the slice thickness, the
    roll (``tests/models/test_quart_dlg.py``'s bars)."""
    hu = data["hu_module"]["rois"]
    bad = {k: hu[k]["value"] for k, v in QUART_HU.items()
           if k not in hu or abs(hu[k]["value"] - v) > QUART_HU_TOL}
    bad.update({f"uniformity {k}": r["value"] for k, r in
                data["uniformity_module"]["rois"].items() if abs(r["value"] - 120) > QUART_HU_TOL})
    dist = data["geometric_module"]["distances"]
    bad.update({k: v for k, v in dist.items() if abs(v - 160) > 2})
    edge = data["geometric_module"]["mean_high_contrast_distance"]
    thick = data["hu_module"]["measured_slice_thickness_mm"]
    if bad or not 0 < edge < 3 or abs(thick - 2.5) > 0.8 \
            or abs(data["phantom_roll_deg"] - roll) > QUART_ROLL_TOL \
            or data["hu_module"]["signal_to_noise"] < 50 \
            or data["hu_module"]["contrast_to_noise"] < 10 or data["warnings"]:
        raise RuntimeError(f"{what}: off the drawn phantom: {bad}, edge {edge}, thickness "
                           f"{thick}, roll {data['phantom_roll_deg']}, warnings "
                           f"{data['warnings']}")
    print(f"{what}: inside the drawn phantom's bars (HU {[hu[k]['value'] for k in QUART_HU]}, "
          f"diameters {[round(v, 4) for v in dist.values()]} mm, edge {edge:.4f} mm, thickness "
          f"{thick:.4f} mm, roll {data['phantom_roll_deg']:.4f} deg)")


def quart_phase(card: str, median, ccl) -> tuple[int, float, list[dict]]:
    """The Quart DVT on the card: a generated 60-slice 512 x 512 series and
    a copy rolled 2 degrees, the 3x3 median's and the CCL kernel's launches
    counted with every input held bit-equal to the twins, the generator's
    bars, card against CPU, warm runs (1, then 5 timed) equal to the first,
    a profile, and the kernels timed at these shapes with their bounds.
    Returns the median's launches and largest error, and the CCL lines."""
    from pylinac_tpu_torch import QuartDVT
    from pylinac_tpu_torch.imggen.ct import generate_quart
    from pylinac_tpu_torch.ops import filters as tfilters

    tmp = tempfile.mkdtemp(prefix="chip_smoke_quart_")
    try:
        t0 = time.perf_counter()
        dirs = {0.0: os.path.join(tmp, "plain"), QUART_ROLL_DEG: os.path.join(tmp, "rolled")}
        for roll, d in dirs.items():
            generate_quart(d, num_slices=QUART_SLICES, roll_deg=roll)
        print(f"inputs: 2 Quart DVT series x {QUART_SLICES} slices of 512 x 512 uint16 "
              f"(one rolled {QUART_ROLL_DEG} deg) in {time.perf_counter() - t0:.1f} s")

        def run(d, device="cuda"):
            q = QuartDVT(d)
            q.analyze(device=device)
            data = result_dict(q)
            if device == "cuda":
                torch.cuda.synchronize()
            return q, data

        median.median3x3.launches = 0
        ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
        with recording_inputs(ccl_entries() + [(tfilters, "median3x3", "median")]) as seen:
            runs = {roll: run(d) for roll, d in dirs.items()}
        torch.cuda.synchronize()
        counts = {"label": ccl.label_batch.launches, "holes": ccl.hole_roots_batch.launches,
                  "median": median.median3x3.launches}
        check_counts(seen, counts, "Quart runs")
        if min(counts.values()) < 1:
            raise RuntimeError(f"the Quart runs launched a kernel no time: {counts}")
        pairs = {**kernel_pairs(ccl), "median": (median.median3x3, median.median3x3_reference)}
        errs = check_path_masks(pairs, seen, "Quart runs")
        print(f"Quart (2 scans): launches {counts}, inputs "
              f"{sorted(Counter(f'{m} {tuple(x.shape)}' for m, x, *_ in seen).items())}")
        worst = 0.0
        for roll, d in dirs.items():
            data = runs[roll][1]
            check_quart_results(data, roll, f"card Quart, roll {roll}")
            _, cpu_data = run(d, "cpu")
            worst = max(worst, compare_tree(data, cpu_data, f"Quart roll {roll} card vs CPU",
                                            ct_tol))
            same_warnings(data, cpu_data, f"Quart roll {roll}")
        print(f"Quart card vs CPU: agree (max difference {worst:.2e})")

        scan = runs[0.0][0]

        def warm_run():
            scan._slice_centroids = None  # a fresh localisation each run
            scan.analyze(device="cuda")
            data = scan.results_data()
            torch.cuda.synchronize()
            return data

        warm, outs = median_runs(card, "warm QuartDVT analyze + "
                                 "results_data of one 60-slice scan", warm_run)
        check_same_texts([results_text(o) for o in outs], "Quart warm runs")
        device_profile(card, "Quart DVT analyze", warm_run, warm)

        slice_img = next(x for m, x, *_ in seen if m == "median")
        frame = slice_img.to(torch.float32)
        kernel_ms, plain_ms = time_pair(median.median3x3, median.median3x3_reference, frame, 50, 5)
        bound_ms, bound_by = bound(8 * frame.numel(), 21 * frame.numel(), F32_INSTR_PER_S)
        print(f"[{card}] median3x3 at {tuple(frame.shape)}, the Quart geometry slice: "
              f"kernel {kernel_ms:.4f} ms, plain twin {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by})")
        lines = []
        for mode in ("label", "holes"):
            kernel, twin = kernel_pairs(ccl)[mode]
            shapes = {}
            for m, masks, args, kwargs in seen:
                if m == mode:
                    shapes.setdefault(tuple(masks.shape), (masks, args, kwargs))
            timed = {}
            for shape, (masks, args, kwargs) in sorted(shapes.items(), key=lambda kv: -np.prod(kv[0])):
                timed[shape] = timed_pair(card, f"Quart ccl {mode}",
                                          lambda x: kernel(x, *args, **kwargs),
                                          lambda x: twin(x, *args, **kwargs), masks, ccl_bound)
            largest = max(timed, key=lambda shape: np.prod(shape))
            lines.append(ccl_line(f"ccl_{mode}_quart", "pylinac_tpu/ops/pallas_label.py:336",
                                  counts[mode], errs.get(mode, 0.0), timed[largest]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts["median"], errs.get("median", 0.0), lines


ACR_CT_HU = {"Air": -1000, "Poly": -95, "Acrylic": 120, "Bone": 955, "Water": 0}
TOMO_HU = {"1": -800, "6": 800, "8": 300, "13": -300, "3": 0}
HU_TOL = 15               # tests/models/test_acr.py, test_cheese.py
TOMO_ROLL_DEG = 2.0
# the CIRS 062M's inserts by the names of ``CIRSHUModule.roi_settings``:
# HU of tissue equivalents (lung inhale and exhale, adipose, breast,
# muscle, liver, trabecular and dense bone)
CIRS_HU = {"1": 0, "2": -800, "3": -500, "4": 40, "5": -40, "6": -90, "7": 240,
           "8": 60, "9": 1250, "10": 900, "11": -800, "12": 200, "13": -500,
           "14": 60, "15": 40, "16": -90, "17": 800}


def draw_cirs062m(dir_out: str, num_slices: int = 20, slice_thickness_mm: float = 2.5,
                  mm_per_pixel: float = 0.7, image_size: int = 512, roll_deg: float = 0.0,
                  noise_hu: float = 3.0, seed: int = 62) -> list[str]:
    """A CIRS 062M series, which neither package generates (the drawing of
    ``tests/test_torch_cheese.py``): a 330 x 290 mm elliptical water body,
    50 mm thick, with 24 mm inserts at ``CIRSHUModule.roi_settings``'
    places, in air; uint16 with intercept -1000."""
    from pylinac_tpu_torch.cheese import CIRSHUModule
    from pylinac_tpu_torch.core import dcm

    rng = np.random.default_rng(seed)
    os.makedirs(dir_out, exist_ok=True)
    center = image_size / 2 - 0.5
    yy, xx = np.mgrid[:image_size, :image_size]
    body = (((xx - center) * mm_per_pixel / 165) ** 2
            + ((yy - center) * mm_per_pixel / 145) ** 2) < 1
    uids = [dcm.generate_uid() for _ in range(3)]
    roll = np.deg2rad(roll_deg)
    paths = []
    for i, z in enumerate((np.arange(num_slices) - num_slices / 2) * slice_thickness_mm):
        hu = np.full((image_size, image_size), -1000.0)
        if abs(z) <= 25:
            hu[body] = 0.0
            for name, s in CIRSHUModule.roi_settings.items():
                a = np.deg2rad(s["angle"]) + roll
                px = center + np.cos(a) * s["distance"] / mm_per_pixel
                py = center + np.sin(a) * s["distance"] / mm_per_pixel
                hu[(yy - py) ** 2 + (xx - px) ** 2 < (12 / mm_per_pixel) ** 2] = CIRS_HU[name]
        hu += rng.standard_normal((image_size, image_size)) * noise_hu
        ds = dcm.Dataset()
        ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.2"
        ds.SOPInstanceUID = dcm.generate_uid()
        ds.StudyInstanceUID, ds.SeriesInstanceUID, ds.FrameOfReferenceUID = uids
        ds.Modality = "CT"
        ds.PatientName = "CIRS^Synthetic"
        ds.PatientID = "CIRS062M"
        ds.PixelSpacing = [mm_per_pixel, mm_per_pixel]
        ds.SliceThickness = slice_thickness_mm
        ds.RescaleSlope = 1.0
        ds.RescaleIntercept = -1000.0
        ds.ImagePositionPatient = [0.0, 0.0, float(z)]
        ds.InstanceNumber = i + 1
        ds.set_pixel_data(np.clip(hu + 1000, 0, 65535).astype(np.uint16))
        path = os.path.join(dir_out, f"cirs_{i:03d}.dcm")
        dcm.dcmwrite(path, ds)
        paths.append(path)
    return paths


def write_two_echo(src: str, dst: str) -> None:
    """A copy of an MR series with a second echo of every axial slice (the
    same series, EchoNumbers 2, 0.9 x the signal)."""
    from pylinac_tpu_torch.core import dcm

    os.makedirs(os.path.join(dst, "echo2"))
    for name in sorted(os.listdir(src)):
        ds = dcm.dcmread(os.path.join(src, name))
        dcm.dcmwrite(os.path.join(dst, name), ds)
        if name != "mr_sag.dcm":
            ds.EchoNumbers = 2
            ds.SOPInstanceUID = dcm.generate_uid()
            ds.set_pixel_data((ds.pixel_array * 0.9).astype(np.uint16))
            dcm.dcmwrite(os.path.join(dst, "echo2", name), ds)


def check_sibling_results(name: str, data: dict, what: str, roll: float = 0.0) -> None:
    """The generators' drawn truths, at the bars of ``tests/models/test_acr.py``,
    ``test_cheese.py`` and ``test_helios.py`` (CIRS: its drawing's inserts)."""
    bad = {}

    def near(key, got, want, tol):
        if not abs(got - want) <= tol:
            bad[key] = got

    if name == "ACRCT":
        for k, hu in ACR_CT_HU.items():
            near(k, data["ct_module"]["rois"][k], hu, HU_TOL)
        for k, v in data["uniformity_module"]["rois"].items():
            near(f"uniformity {k}", v, 0, 10)
        rmtf = list(data["spatial_resolution_module"]["lpmm_to_rmtf"].values())
        if not (data["low_contrast_module"]["cnr"] > 5 and abs(rmtf[0] - 1) < 1e-9
                and rmtf[-1] < 0.5):
            bad["cnr, rMTF"] = (data["low_contrast_module"]["cnr"], rmtf)
        near("roll", data["phantom_roll_deg"], roll, 1)
    elif name == "ACRMRILarge":
        for k, p in data["geometric_distortion_module"]["profiles"].items():
            near(f"width {k}", p["width (mm)"], 200, 4)
        sag = data["sagittal_localizer_module"]["profiles"]
        for k, p in sag.items():
            near(f"sagittal {k}", p["width (mm)"], 148, 3)
        u = data["uniformity_module"]
        if len(sag) != 4 or not (u["piu"] > 95 and u["piu_passed"] and u["psg"] < 3):
            bad["sagittal, PIU, PSG"] = (len(sag), u["piu"], u["psg"])
        near("thickness", data["slice1"]["measured_slice_thickness_mm"], 5, 1)
        near("slice 1 shift", data["slice1"]["slice_shift_mm"], 0, 1)
        near("slice 11 shift", data["slice11"]["slice_shift_mm"], 0, 1)
        near("low-contrast score", data["low_contrast_multi_slice_module"]["score"], 16, 4)
        near("roll", data["phantom_roll_deg"], 0, 1.5)
    elif name == "TomoCheese":
        for k, hu in TOMO_HU.items():
            near(f"ROI {k}", data["rois"][k]["median"], hu, HU_TOL)
        if len(data["rois"]) != 20:
            bad["ROIs"] = len(data["rois"])
        near("roll", data["phantom_roll"], roll, 0.7)
    elif name == "CIRS062M":
        for k, hu in CIRS_HU.items():
            near(f"ROI {k}", data["rois"][k]["median"], hu, HU_TOL)
        near("roll", data["phantom_roll"], roll, 0.7)
    else:  # GEHeliosCTDaily
        cs, nu, lc = data["contrast_scale"], data["noise_uniformity"], data["low_contrast"]
        near("plexiglass", cs["mean_hu_plastic"], 120, 10)
        near("water", cs["mean_hu_water"], 0, 10)
        near("difference", cs["hu_difference"], 120, 12)
        near("centre", nu["center_mean_hu"], 0, 10)
        near("uniformity", nu["means_diff"], 0, 10)
        near("noise", nu["noise_center_std"], 5, 5)
        near("low contrast mean", lc["mean"], 0, 10)
        near("low contrast std", lc["std"], 5, 5)
        mtf = list(data["high_contrast"]["mtf_lp_mm"].values())
        if len(lc["slices"]) != 3 or len(mtf) != 9 or data["phantom_roll_deg"] != 0:
            bad["slices, MTF, roll"] = (len(lc["slices"]), mtf, data["phantom_roll_deg"])
    if bad:
        raise RuntimeError(f"{what}: off the drawn phantom: {bad}")
    print(f"{what}: inside the drawn phantom's bars")


def ct_siblings_phase(card: str, ccl, flood) -> tuple[int, float, list[dict]]:
    """ACR CT, ACR MRI Large, TomoCheese, CIRS 062M and GE Helios on the
    card: generated (CIRS drawn) series at the sizes clinics scan, each
    class's CCL and flood launches counted with every kernel input held
    bit-equal to its twin, the drawn truths, card against CPU (warnings on
    message and category), warm runs (1, then 5 timed) equal to the first,
    a profile of a warm ACR MRI run, and the kernels timed at the new
    shapes with their bounds. Returns the flood kernel's launches and
    largest error, and the CCL lines."""
    from pylinac_tpu_torch import ACRCT, CIRS062M, ACRMRILarge, GEHeliosCTDaily, TomoCheese
    from pylinac_tpu_torch.imggen.ct import generate_acr_ct, generate_helios, generate_tomocheese
    from pylinac_tpu_torch.imggen.mri import generate_acr_mri
    from pylinac_tpu_torch.ops import label as tlabel

    classes = {"ACRCT": ACRCT, "ACRMRILarge": ACRMRILarge, "TomoCheese": TomoCheese,
               "CIRS062M": CIRS062M, "GEHeliosCTDaily": GEHeliosCTDaily}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_siblings_")
    try:
        t0 = time.perf_counter()
        d = {k: os.path.join(tmp, k) for k in ("acr_ct", "acr_mri", "acr_mri_two_echo", "tomo",
                                              "tomo_rolled", "cirs", "helios")}
        generate_acr_ct(d["acr_ct"])
        generate_acr_mri(d["acr_mri"])
        write_two_echo(d["acr_mri"], d["acr_mri_two_echo"])
        generate_tomocheese(d["tomo"])
        generate_tomocheese(d["tomo_rolled"], roll_deg=TOMO_ROLL_DEG)
        draw_cirs062m(d["cirs"])
        generate_helios(d["helios"])
        print(f"inputs: ACR CT 32 x 512 x 512 at 5 mm; ACR MRI Large 11 axial 512 x 512 at 10 mm "
              f"and the sagittal localiser, and a two-echo copy; TomoCheese 24 x 512 x 512 and a "
              f"copy rolled {TOMO_ROLL_DEG} deg; CIRS 062M 20 x 512 x 512 (drawn); GE Helios 40 x "
              f"512 x 512; in {time.perf_counter() - t0:.1f} s")
        runs = [("ACRCT", "acr_ct", 0.0), ("ACRMRILarge", "acr_mri", 0.0),
                ("ACRMRILarge", "acr_mri_two_echo", 0.0), ("TomoCheese", "tomo", 0.0),
                ("TomoCheese", "tomo_rolled", TOMO_ROLL_DEG), ("CIRS062M", "cirs", 0.0),
                ("GEHeliosCTDaily", "helios", 0.0)]

        def run(name, key, device="cuda"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                obj = classes[name](d[key])
                obj.analyze(device=device)
                data = result_dict(obj)
            if device == "cuda":
                torch.cuda.synchronize()
            return obj, data

        entries = ccl_entries() + [(tlabel, "flood_from_border", "flood")]
        pairs = {**kernel_pairs(ccl),
                 "flood": (flood.flood_from_border_batch, flood.flood_from_border_reference)}
        totals, seen_all, worst, card_data = Counter(), [], {}, {}
        for name, key, roll in runs:
            ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
            flood.flood_from_border_batch.launches = 0
            with recording_inputs(entries) as seen:
                obj, data = run(name, key)
            counts = {"label": ccl.label_batch.launches, "holes": ccl.hole_roots_batch.launches,
                      "flood": flood.flood_from_border_batch.launches}
            what = f"{name} on {key}"
            check_counts(seen, counts, what)
            needs = ("label", "holes", "flood") if name == "ACRMRILarge" else ("label", "holes")
            if min(counts[m] for m in needs) < 1:
                raise RuntimeError(f"the {what} launched a kernel of its path no time: {counts}")
            errs = check_path_masks(pairs, seen, what)
            for mode, e in errs.items():
                worst[mode] = max(worst.get(mode, 0.0), e)
            totals.update(counts)
            seen_all += seen
            print(f"{what}: launches {counts}, inputs "
                  f"{sorted(Counter(f'{m} {tuple(x.shape)}' for m, x, *_ in seen).items())}")
            check_sibling_results(name, data, f"card {what}", roll)
            card_data[key] = obj, data
        one, two = card_data["acr_mri"][1], card_data["acr_mri_two_echo"][1]
        echo_warning = [w["message"] for w in two["warnings"]]
        if echo_warning != ["Multiple echoes found ({1, 2}) and no echo number was passed. "
                            "Using echo # 1"] or card_data["acr_mri_two_echo"][0]._host_vol.shape[0] != 11:
            raise RuntimeError(f"the two-echo MR series: warnings {echo_warning}, host volume "
                               f"{card_data['acr_mri_two_echo'][0]._host_vol.shape}")
        compare_tree({k: v for k, v in two.items() if k != "warnings"},
                     {k: v for k, v in one.items() if k != "warnings"},
                     "two-echo MR against one echo", ct_tol)
        print("two-echo MR: echo 1 taken once, its warning in results_data(), results equal "
              "to the one-echo series'")
        worst_cpu = 0.0
        for name, key, _ in runs:
            _, cpu_data = run(name, key, "cpu")
            data = card_data[key][1]
            worst_cpu = max(worst_cpu, compare_tree(data, cpu_data, f"{name} {key} card vs CPU",
                                                    ct_tol))
            same_warnings(data, cpu_data, f"{name} {key}")
        print(f"ACR, cheese and Helios card vs CPU: agree (max difference {worst_cpu:.2e})")

        for name, key, _ in runs:
            if key in ("acr_mri_two_echo", "tomo_rolled"):
                continue
            if name == "ACRMRILarge":  # analyze takes the sagittal image out: a new object a run
                fresh = [classes[name](d[key]) for _ in range(WARM_RUNS)]

                def warm_run():
                    obj = fresh.pop()
                    obj.analyze(device="cuda")
                    data = obj.results_data()
                    torch.cuda.synchronize()
                    return data
            else:
                obj = card_data[key][0]

                def warm_run(obj=obj):
                    obj._slice_centroids = None  # a fresh localisation each run
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        obj.analyze(device="cuda")
                        data = obj.results_data()
                    torch.cuda.synchronize()
                    return data

            warm, outs = median_runs(card, f"warm {name} analyze + results_data of {key}",
                                     warm_run, WARM_RUNS)
            check_same_texts([results_text(o) for o in outs], f"{name} warm runs")
            if name == "ACRCT":
                stage_table(card, "ACRCT of 32 slices", warm_run)
            if name == "ACRMRILarge":
                fresh = [classes[name](d[key])]
                device_profile(card, "ACR MRI Large analyze", warm_run, warm)

        timed, lines = {}, []
        for mode in ("label", "holes", "flood"):
            kernel, twin = pairs[mode]
            shapes = {}
            for m, masks, args, kwargs in seen_all:
                if m == mode:
                    masks = masks if masks.dim() == 3 else masks[None]
                    shapes.setdefault(tuple(masks.shape), (masks, args, kwargs))
            bound_ = ccl_bound if mode != "flood" else functools.partial(flood_bound,
                                                                          entry="flood")
            for shape, (masks, args, kwargs) in sorted(shapes.items(),
                                                       key=lambda kv: -np.prod(kv[0])):
                timed[mode, shape] = timed_pair(
                    card, f"ACR/cheese/Helios {mode}", lambda x: kernel(x, *args, **kwargs),
                    lambda x: twin(x, *args, **kwargs), masks, bound_)
            if mode != "flood":
                largest = max((s for m, s in timed if m == mode), key=np.prod)
                lines.append(ccl_line(f"ccl_{mode}_acr_cheese_helios",
                                      "pylinac_tpu/ops/pallas_label.py:336", totals[mode],
                                      worst.get(mode, 0.0), timed[mode, largest]))
        print(f"ACR, cheese and Helios launches: {dict(totals)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return totals["flood"], worst.get("flood", 0.0), lines


# the planar phantoms (planar_imaging.py) and the profile-plugin field
# analysis: the phase's inputs at clinical detector sizes
PLANAR_FC2_EDGE_MM = 15   # every BB of the 150 mm field within 15 mm of its edge
MAMMO_DPMM = 1 / 0.07     # a Selenia-class 18 x 24 cm detector at 70 um
MAMMO_SHAPE = (3328, 2560)
# a speck's visibility grows with its radius in pixels: the recipe's 400 at
# 5 px/mm, scaled to the frame's 14.3 (noise-only groups reach 809 there,
# the drawn specks 1583)
MAMMO_SPECK_VISIBILITY = 400 * MAMMO_DPMM / 5
LONGTAIL_BG, LONGTAIL_SCALE, LONGTAIL_NOISE = 0.45, 40000, 0.002


def _disk(arr, cy, cx, radius, value) -> None:
    """``arr[(yy - cy)**2 + (xx - cx)**2 <= radius**2] = value`` over the
    disk's bounding window only (the same pixels as over the frame)."""
    h, w = arr.shape
    r0, r1 = max(int(np.floor(cy - radius)) - 1, 0), min(int(np.ceil(cy + radius)) + 2, h)
    c0, c1 = max(int(np.floor(cx - radius)) - 1, 0), min(int(np.ceil(cx + radius)) + 2, w)
    if r0 >= r1 or c0 >= c1:
        return
    yy, xx = np.mgrid[r0:r1, c0:c1]
    window = arr[r0:r1, c0:c1]
    window[(yy - cy) ** 2 + (xx - cx) ** 2 <= radius ** 2] = value


def draw_qc3(path: str, sim) -> str:
    """The QC-3 of ``tests/models/test_planar_imaging.py:27`` on ``sim``'s
    frame: a rectangle rotated 45 degrees whose bbox is the class's 168 mm,
    contrast disks and high-contrast stripes at the class's ROI places."""
    from pylinac_tpu_torch import StandardImagingQC3
    from pylinac_tpu_torch.imggen.layers import ArrayLayer

    h, w = sim.shape
    dpmm = 1 / sim.pixel_size
    arr = np.zeros((h, w), np.float64)
    cy, cx = h / 2, w / 2
    side = 168 * dpmm
    b = side * np.sqrt(2) / 2.25
    a = 1.25 * b
    theta = np.deg2rad(45)
    yy, xx = np.mgrid[:h, :w]
    u = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
    v = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
    arr[(np.abs(u) <= a / 2) & (np.abs(v) <= b / 2)] = 500.0
    radius = side * 0.0896
    for stng in StandardImagingQC3.low_contrast_roi_settings.values():
        ang = np.deg2rad(45 + stng["angle"])
        dist = radius * stng["distance from center"]
        _disk(arr, cy + np.sin(ang) * dist, cx + np.cos(ang) * dist,
              radius * stng["roi radius"], 560.0)
    for amp, stng in zip([200, 150, 100, 60, 30],
                         StandardImagingQC3.high_contrast_roi_settings.values()):
        ang = np.deg2rad(45 + stng["angle"])
        dist = radius * stng["distance from center"]
        mask = ((yy - (cy + np.sin(ang) * dist)) ** 2 + (xx - (cx + np.cos(ang) * dist)) ** 2
                <= (radius * stng["roi radius"]) ** 2)
        arr[mask] = np.where((xx // 3) % 2 == 0, 500 + amp, 500 - amp)[mask]
    arr += np.random.default_rng(42).normal(0, 2, arr.shape)
    sim.add_layer(ArrayLayer((arr.clip(0) * 40).astype(np.uint16)))
    sim.generate_dicom(path)
    return path


def longtail_specs():
    """``tests/models/test_planar_longtail.py``'s 13 phantoms: (class,
    angle, disk sign, outline, methods patched out, extra blocks)."""
    import pylinac_tpu_torch as p

    return [(p.LasVegas, 0, 1, "rect", ("_preprocess",), ()),
            (p.ElektaLasVegas, 0, 1, "rect", ("_preprocess",), ()),
            (p.PTWEPIDQC, 0, -1, "rect", (), ()),
            (p.IBAPrimusA, 0, 1, "rect", (), ("plate",)),
            (p.StandardImagingQC3, 45, 1, "rect", (), ()),
            (p.StandardImagingQCkV, 45, 1, "rect", (), ()),
            (p.SNCkV, 135, 1, "rect", (), ()),
            (p.SNCMV, 45, 1, "rect", (), ()),
            (p.SNCMV12510, 45, 1, "rect", (), ()),
            (p.LeedsTOR, 0, 1, "circle", ("_preprocess", "_check_inversion"), ("leeds_block",)),
            (p.LeedsTORBlue, 0, 1, "circle", ("_preprocess", "_check_inversion"),
             ("leeds_block",)),
            (p.DoselabMC2kV, 0, 1, "rect", (), ()),
            (p.DoselabMC2MV, 0, 1, "rect", (), ())]


def draw_longtail(spec, path: str) -> float:
    """One phantom of ``tests/models/test_planar_longtail.py:95`` on an
    AS1000 frame (its own ROI tables drawn at its bbox size); returns the
    ROI radius R the analysis overrides."""
    from types import SimpleNamespace

    from pylinac_tpu_torch.imggen.layers import ArrayLayer
    from pylinac_tpu_torch.imggen.simulators import AS1000Image

    cls, angle, sign, shape, _, extra = spec
    sim = AS1000Image(sid=1000)
    h, w = sim.shape
    dpmm = 1 / sim.pixel_size
    cy, cx = h / 2, w / 2
    bg = LONGTAIL_BG
    arr = np.zeros((h, w), np.float64)
    side = np.sqrt(cls.phantom_bbox_size_mm2) * dpmm
    if shape == "circle":
        _disk(arr, cy, cx, side / 2, bg)
    else:
        arr[int(cy - side / 2):int(cy + side / 2), int(cx - side / 2):int(cx + side / 2)] = bg
    stub = SimpleNamespace(phantom_ski_region=SimpleNamespace(bbox_area=side * side))
    settings = (list(cls.low_contrast_roi_settings.values())
                + list(cls.low_contrast_background_roi_settings.values())
                + list(cls.high_contrast_roi_settings.values()))
    ext = max(s["distance from center"] + s["roi radius"] for s in settings)
    R = min(cls._phantom_radius_calc(stub), 0.92 * (min(h, w) / 2) / ext)
    if "plate" in extra:
        _disk(arr, cy, cx, (ext + 0.3) * R, bg)
        arr[int(cy - side / 2):int(cy + side / 2), int(cx - side / 2):int(cx + side / 2)] = bg + 0.08
    if "leeds_block" in extra:
        bh = np.sqrt(0.23) * side / 2
        arr[int(cy - bh):int(cy + bh), int(cx - bh):int(cx + bh)] = bg + 0.08
    n = len(cls.low_contrast_roi_settings)
    for i, stng in enumerate(cls.low_contrast_roi_settings.values()):
        ang = np.deg2rad(angle + stng["angle"])
        d = R * stng["distance from center"]
        _disk(arr, cy + np.sin(ang) * d, cx + np.cos(ang) * d, R * stng["roi radius"] + 2,
              bg + sign * (0.05 + 0.25 * (i + 1) / n) * bg)
    n_hc = len(cls.high_contrast_roi_settings)
    base = bg + 0.08 if "leeds_block" in extra else bg
    yy, xx = np.mgrid[:h, :w]
    for i, stng in enumerate(cls.high_contrast_roi_settings.values()):
        amp = 0.25 * bg * (1 - 0.8 * i / max(n_hc - 1, 1))
        ang = np.deg2rad(angle + stng["angle"])
        d, rr = R * stng["distance from center"], R * stng["roi radius"]
        mask = ((yy - (cy + np.sin(ang) * d)) ** 2 + (xx - (cx + np.cos(ang) * d)) ** 2
                <= (rr + 2) ** 2)
        half_period = int(np.clip(rr / 2, 1, 4))
        arr[mask] = np.where((xx // half_period) % 2 == 0, base + amp, base - amp)[mask]
    arr += np.random.default_rng(7).normal(0, LONGTAIL_NOISE, arr.shape)
    sim.add_layer(ArrayLayer((arr.clip(0) * LONGTAIL_SCALE).astype(np.uint16)))
    sim.generate_dicom(path)
    return R


def draw_mammo(path: str, dpmm: float, shape: tuple[int, int]) -> str:
    """``tests/models/test_acr_mammo.py:13``'s phantom at ``dpmm`` on a
    ``shape`` frame: a bright 70 x 130 mm block, 4 strong masses of 6, 3
    groups of bright specks of 6, 4 long fibres (10 mm) and 2 short ones
    (3 mm); every size in mm, as the recipe's."""
    from pylinac_tpu_torch import ACRDigitalMammography as ACR
    from pylinac_tpu_torch.core import dcm
    from pylinac_tpu_torch.core.array_utils import array_to_dicom

    rng = np.random.default_rng(3)
    h, w = shape
    cy, cx = h / 2, w / 2
    arr = np.full((h, w), 100.0)
    arr[int(cy - 65 * dpmm):int(cy + 65 * dpmm), int(cx - 35 * dpmm):int(cx + 35 * dpmm)] = 500.0
    for idx, stng in enumerate(ACR.low_contrast_roi_settings.values()):
        a = np.deg2rad(stng["angle"])
        _disk(arr, cy + np.sin(a) * stng["distance from center"] * dpmm,
              cx + np.cos(a) * stng["distance from center"] * dpmm,
              stng["roi radius"] * dpmm * 1.8, 500 + (400 if idx < 4 else 0))
    for g_idx, grp in enumerate(ACR.speck_group_roi_settings.values()):
        if g_idx >= 3:
            continue
        gx, gy = cx + grp["x offset"] * dpmm, cy + grp["y offset"] * dpmm
        for stng in ACR.speck_roi_settings.values():
            a = np.deg2rad(stng["angle"])
            _disk(arr, gy + np.sin(a) * stng["distance from center"] * dpmm,
                  gx + np.cos(a) * stng["distance from center"] * dpmm, 0.4 * dpmm, 30000)
    for f_idx, stng in enumerate(ACR.fibers_roi_settings.values()):
        fx, fy = cx + stng["x offset"] * dpmm, cy + stng["y offset"] * dpmm
        length = 10 if f_idx < 4 else 3
        a = np.deg2rad(stng["fiber_orientation"])
        ts = np.linspace(-length / 2 * dpmm, length / 2 * dpmm, 200)
        width = max(stng["fiber_diameter"] * dpmm / 2, 1.0)
        for t in ts:
            _disk(arr, fy + t * np.cos(a), fx + t * np.sin(a), width, 1200)
    arr += rng.normal(0, 1.0, arr.shape)
    ds = array_to_dicom(arr.clip(0).astype(np.uint16), sid=1000, gantry=0, coll=0, couch=0,
                        dpi=25.4 * dpmm)
    dcm.dcmwrite(path, ds)
    return path


def planar_tol(path: str, a: float) -> float:
    """The planar bars, card against CPU: mm 0.01, % 0.1, contrast, CNR and
    rMTF 0.1 % of the value, px (and degrees) 1e-3."""
    key = path.rsplit("/", 1)[-1]
    if "mm" in key:
        return MM_TOL
    if "percent" in key or "%" in key:
        return PCT_TOL
    if "contrast" in key or "cnr" in key or path.startswith("/mtf"):
        return 1e-3 * abs(a)
    return PX_TOL


def check_planar_results(name: str, obj, data: dict, what: str) -> None:
    """Each input against its drawing, at the JAX tests' bars."""
    bad = {}
    if name == "StandardImagingQC3":
        h, w = obj.image.shape
        if not (abs(obj.phantom_angle - 45) < 0.1 and abs(obj.phantom_center.x - w / 2) < 5
                and abs(obj.phantom_center.y - h / 2) < 5):
            bad["angle, centre"] = (obj.phantom_angle, obj.phantom_center)
        mtfs = list(obj.mtf.norm_mtfs.values())
        if not (data["num_contrast_rois_seen"] == 5 and data["median_contrast"] > 0.01
                and abs(mtfs[0] - 1) < 1e-9 and mtfs[-1] < mtfs[0]):
            bad["seen, contrast, MTF"] = (data["num_contrast_rois_seen"],
                                          data["median_contrast"], mtfs)
    elif "field_size_x_mm" in data:
        size = 150 if name == "StandardImagingFC2" else 100
        if not (abs(data["field_size_x_mm"] - size) < 1.5
                and abs(data["field_size_y_mm"] - size) < 1.5
                and abs(data["field_epid_offset_x_mm"]) < 0.5
                and abs(data["field_epid_offset_y_mm"]) < 0.5
                and abs(data["field_bb_offset_x_mm"]) < 1.0
                and abs(data["field_bb_offset_y_mm"]) < 1.0):
            bad["field, offsets"] = {k: v for k, v in data.items() if k.endswith("_mm")}
    elif name == "ACRDigitalMammography":
        lengths = [r["fiber_length"] for r in data["fiber_rois"][:4]]
        if not (data["mass_score"] == 4 and data["speck_group_score"] == 3
                and data["fiber_score"] == 4 and all(abs(x - 12) < 4 for x in lengths)):
            bad["masses, specks, fibres"] = (data["mass_score"], data["speck_group_score"],
                                             data["fiber_score"], lengths)
    elif data.get("analysis_type") != obj.common_name:
        bad["analysis type"] = data.get("analysis_type")
    if bad:
        raise RuntimeError(f"{what}: off the drawn phantom: {bad}")


def planar_phase(card: str, median, ccl) -> tuple[int, float, list[dict]]:
    """The planar phantoms on the card: a QC-3 on an AS1200 frame (full
    detection), an FC-2 on AS1200 (150 mm field, the 15 x 15 BB set, every
    BB through the high-pass), the 13 long-tail classes and the 4 FC-2
    variants on AS1000 frames by the JAX tests' recipes, and the ACR
    mammography phantom on a 2560 x 3328 detector at 0.07 mm; the 3x3
    median's and the CCL kernel's launches counted with every input held
    bit-equal to the twins (Canny's hysteresis, ``keep_largest``,
    ``regionprops``, the BB windows, the fibres), the drawings, card against
    CPU (the mammography phantom on the CPU at its test size, 1024 x 768 at
    0.2 mm: at 8.5 M pixels the CPU run takes about 200 s, so
    ``scripts/planar_mammo_cpu.py`` compares that size; the fibres'
    closings of the full frame are held card against CPU here), warm runs equal
    (QC-3 1 + 5, FC-2 and mammography 1 + 3), a profile of a warm QC-3, the kernels timed at the new shapes; then
    ``FieldProfileAnalysis`` of an AS1200 open field under each edge (host
    code) against the drawn width. Returns the median's launches and
    largest error, and the CCL lines."""
    import pylinac_tpu_torch as p
    from pylinac_tpu_torch.imggen.layers import FilteredFieldLayer, GaussianFilterLayer
    from pylinac_tpu_torch.imggen.simulators import AS1000Image, AS1200Image
    from pylinac_tpu_torch.imggen.utils import generate_lightrad
    from pylinac_tpu_torch import planar_imaging as tplanar
    from pylinac_tpu_torch.ops import edges as tedges
    from pylinac_tpu_torch.ops import filters as tfilters
    from pylinac_tpu_torch.ops import morphology as tmorph

    tmp = tempfile.mkdtemp(prefix="chip_smoke_planar_")
    try:
        t0 = time.perf_counter()
        paths = {"qc3": draw_qc3(os.path.join(tmp, "qc3.dcm"), AS1200Image(sid=1000)),
                 "fc2": os.path.join(tmp, "fc2.dcm"),
                 "mammo": draw_mammo(os.path.join(tmp, "mammo.dcm"), MAMMO_DPMM, MAMMO_SHAPE),
                 "mammo_small": draw_mammo(os.path.join(tmp, "mammo_small.dcm"), 5.0, (1024, 768))}
        generate_lightrad(AS1200Image(sid=1000), file_out=paths["fc2"], field_size_mm=(150, 150),
                          bb_size_mm=4, bb_positions=((-65, -65), (-65, 65), (65, -65), (65, 65)),
                          final_layers=[GaussianFilterLayer(sigma_mm=1)])
        fc2_variants = [("IMTLRad", ((0, 0),), 3),
                        ("DoselabRLf", ((-45, -17), (17, -45), (-17, 45), (45, 17)), 4),
                        ("IsoAlign", ((0, 0), (-25, 0), (25, 0), (0, -25), (0, 25)), 4),
                        ("SNCFSQA", ((-40, 40),), 4)]
        for name, bbs, size in fc2_variants:
            paths[name] = os.path.join(tmp, f"{name}.dcm")
            generate_lightrad(AS1000Image(sid=1000), file_out=paths[name],
                              field_size_mm=(100, 100), bb_size_mm=size, bb_positions=bbs,
                              final_layers=[GaussianFilterLayer(sigma_mm=1)])
        overrides = {}
        for spec in longtail_specs():
            key = f"lt_{spec[0].__name__}"
            paths[key] = os.path.join(tmp, f"{key}.dcm")
            overrides[key] = draw_longtail(spec, paths[key])
        fpa_path = os.path.join(tmp, "open.dcm")
        sim = AS1200Image(sid=1000)
        sim.add_layer(FilteredFieldLayer(field_size_mm=(150, 150)))
        sim.add_layer(GaussianFilterLayer(sigma_mm=1))
        sim.generate_dicom(fpa_path)
        print(f"inputs: QC-3 and FC-2 on AS1200 (1280 x 1280), 13 long-tail phantoms and 4 FC-2 "
              f"variants on AS1000 (768 x 1024), ACR mammography {MAMMO_SHAPE[1]} x "
              f"{MAMMO_SHAPE[0]} at 0.07 mm and 768 x 1024 at 0.2 mm, an AS1200 open field; "
              f"in {time.perf_counter() - t0:.1f} s")

        specs = {f"lt_{s[0].__name__}": s for s in longtail_specs()}
        runs = ([("StandardImagingQC3", "qc3", {}),
                 ("StandardImagingFC2", "fc2", {"bb_edge_threshold_mm": PLANAR_FC2_EDGE_MM}),
                 ("ACRDigitalMammography", "mammo",
                  {"invert": False, "low_contrast_visibility_threshold": 400,
                   "speck_group_visibility_threshold": MAMMO_SPECK_VISIBILITY})]
                + [(name, name, {}) for name, _, _ in fc2_variants]
                + [(specs[k][0].__name__, k, {"ssd": 1000, "angle_override": specs[k][1],
                                             "size_override": overrides[k]}) for k in specs])

        def run(name, key, analyze, device="cuda"):
            cls = getattr(p, name)
            patch = specs[key][4] if key in specs else ()
            saved = {a: cls.__dict__.get(a) for a in patch}
            for a in patch:
                setattr(cls, a, lambda self: None)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    obj = cls(paths[key])
                    kw = dict(analyze)
                    if key in specs:
                        h, w = obj.image.shape
                        kw["center_override"] = (w / 2, h / 2)
                    obj.analyze(device=device, **kw)
                    data = result_dict(obj)
            finally:
                for a in patch:
                    if saved[a] is None:
                        delattr(cls, a)
                    else:
                        setattr(cls, a, saved[a])
            if device == "cuda":
                torch.cuda.synchronize()
            return obj, data

        entries = ccl_entries() + [(tedges, "label_batch", "label"),
                                   (tfilters, "median3x3", "median")]
        closings = []
        pairs = {**kernel_pairs(ccl), "median": (median.median3x3, median.median3x3_reference)}
        totals, seen_all, worst, card_data = Counter(), [], {}, {}
        for name, key, analyze in runs:
            median.median3x3.launches = 0
            ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
            with recording_inputs(entries) as seen, \
                    recording_inputs([(tplanar, "binary_closing", "closing")]) as closed:
                obj, data = run(name, key, analyze)
            closings += closed
            counts = {"label": ccl.label_batch.launches, "holes": ccl.hole_roots_batch.launches,
                      "median": median.median3x3.launches}
            what = f"{name} on {key}"
            check_counts(seen, counts, what)
            detects = key in ("qc3", "mammo") or name in ("LasVegas", "ElektaLasVegas",
                                                          "PTWEPIDQC")
            needs = (("median", "label") if "field_size_x_mm" in data
                     else ("label", "holes") if detects else ())
            if any(counts[m] < 1 for m in needs):
                raise RuntimeError(f"the {what} launched a kernel of its path no time: {counts}")
            if seen:
                for mode, e in check_path_masks(pairs, seen, what).items():
                    worst[mode] = max(worst.get(mode, 0.0), e)
            totals.update(counts)
            seen_all += seen
            print(f"{what}: launches {counts}")
            check_planar_results(name, obj, data, f"card {what}")
            card_data[key] = data
        if totals["median"] < 1 + 4:
            raise RuntimeError(f"the FC-2 family's medians: {totals['median']} launches")
        # the fibres' binary counts are a cuDNN convolution on the card
        for _, mask, args, _ in closings:
            if not torch.equal(tmorph.binary_closing(mask, *args).cpu(),
                               tmorph.binary_closing(mask.cpu(), *args)):
                raise RuntimeError(f"binary_closing at {tuple(mask.shape)}: card != CPU")
        if len(closings) < 6:
            raise RuntimeError(f"the fibres ran {len(closings)} closings")
        print(f"fibre closings: {len(closings)} at "
              f"{sorted({tuple(m.shape) for _, m, _, _ in closings})}, card equal to CPU")

        worst_cpu = 0.0
        for name, key, analyze in runs:
            if key == "mammo":  # at the recipe's size and bars
                key, analyze = "mammo_small", {**analyze, "speck_group_visibility_threshold": 400}
                obj, data = run(name, key, analyze)
                check_planar_results(name, obj, data, f"card {name} on {key}")
            else:
                data = card_data[key]
            _, cpu_data = run(name, key, analyze, "cpu")
            worst_cpu = max(worst_cpu, compare_tree(data, cpu_data, f"{name} {key} card vs CPU",
                                                    planar_tol))
            same_warnings(data, cpu_data, f"{name} {key}")
        print(f"planar card vs CPU: agree on {len(runs)} inputs (max difference "
              f"{worst_cpu:.2e})")

        for name, key, analyze in runs[:3]:
            n_warm = WARM_RUNS if key == "qc3" else 4  # 1 + 3 for the slower two
            fresh = [getattr(p, name)(paths[key]) for _ in range(n_warm)]

            def warm_run(analyze=analyze):
                obj = fresh.pop()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    obj.analyze(device="cuda", **analyze)
                    data = obj.results_data()
                torch.cuda.synchronize()
                return data

            warm, outs = median_runs(card, f"warm {name} analyze + results_data of {key}",
                                     warm_run, n_warm)
            check_same_texts([results_text(o) for o in outs], f"{name} warm runs")
            if name == "StandardImagingQC3":
                fresh = [getattr(p, name)(paths[key])]
                device_profile(card, "QC-3 analyze (AS1200)", warm_run, warm)

        timed, lines = {}, []
        for mode in ("label", "holes", "median"):
            kernel, twin = pairs[mode]
            shapes = {}
            for m, masks, args, kwargs in seen_all:
                if m == mode:
                    shapes.setdefault(tuple(masks.shape), (masks, args, kwargs))
            for shape in sorted(shapes, key=lambda s: -np.prod(s))[:3]:
                masks, args, kwargs = shapes[shape]
                if mode == "median":
                    x = masks.to(torch.float32)
                    kernel_ms, plain_ms = time_pair(median.median3x3, median.median3x3_reference,
                                                    x, 50, 3)
                    bound_ms, bound_by = bound(8 * x.numel(), 21 * x.numel(), F32_INSTR_PER_S)
                    print(f"[{card}] median3x3 at {tuple(x.shape)}, the FC-2 frame: kernel "
                          f"{kernel_ms:.4f} ms, plain twin {plain_ms:.3f} ms, bound "
                          f"{bound_ms:.5f} ms ({bound_by})")
                    continue
                timed[mode, shape] = timed_pair(
                    card, f"planar ccl {mode}", lambda x: kernel(x, *args, **kwargs),
                    lambda x: twin(x, *args, **kwargs), masks, ccl_bound)
            if mode != "median":
                largest = max((s for m, s in timed if m == mode), key=np.prod)
                lines.append(ccl_line(f"ccl_{mode}_planar", "pylinac_tpu/ops/pallas_label.py:"
                                      + ("127" if mode == "label" else "289"),
                                      totals[mode], worst.get(mode, 0.0), timed[mode, largest]))

        widths = {}
        for edge in ("FWHM", "Inflection Derivative", "Inflection Hill"):
            t1 = time.perf_counter()
            fpa = p.FieldProfileAnalysis(fpa_path)
            fpa.analyze(edge_type=edge)
            data = fpa.results_data(as_dict=True)
            ms = (time.perf_counter() - t1) * 1e3
            widths[edge] = (data["x_metrics"]["Field Width (mm)"],
                            data["y_metrics"]["Field Width (mm)"])
            if not all(abs(w - 150) < 1.0 for w in widths[edge]):
                raise RuntimeError(f"FieldProfileAnalysis {edge}: widths {widths[edge]}, drawn 150")
            print(f"[{card}] FieldProfileAnalysis {edge} on the AS1200 open field (host): "
                  f"{ms:.1f} ms, widths {widths[edge]} mm")
        print(f"planar launches: {dict(totals)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return totals["median"], worst.get("median", 0.0), lines


# the nuclear-medicine suite (nuclear.py): the phase's inputs at clinical
# sizes; the planar frames at 0.56 mm, the largest pixel NEMA bins by 8
# (0.55 mm would bin by 16: 8 x 0.55 = 4.4 mm < 4.48 mm)
NM_PLANAR_MM = 0.56
NM_PLANAR_SHAPE = (1024, 1024)
NM_FLOOD_COUNTS = 30e6          # counts a frame (NEMA NU 1 intrinsic flood)
NM_SPECT_MM = 4.42
NM_SPECT_SIZE = 128
NM_COR_MM = 4.8
NM_COR_AXIS_PX = 64.5           # the axis of rotation 0.5 px off the frame's centre
NM_COR_RADIUS_PX = 15
NM_COR_STEP = 3.0               # degrees: 120 projections over 360
NM_POINT_XYZ = (64.3, 63.6, 64.4)   # near the centre, where the fit starts
NM_POINT_SIGMA = (1.8, 2.2)     # px in-plane and along z
NM_CYLINDER_SLICES = (40, 82)   # a 186 mm Jaszczak cylinder of 216 mm
NM_SPHERE_SLICE = 70
NM_SPHERES = ((-10, 38), (-70, 31.8), (-130, 25.4), (-190, 19.1), (110, 15.9), (50, 12.7))
NM_LSF_FWHM_MM = 3.5            # the bars' drawn line spread
NM_BAR_SEPARATION_MM = 100
NM_BAR_WIDTHS = (3.5, 3.0, 2.5, 2.0)
NM_MCR_FRAMES = 120
NM_MCR_PEAK = 72
NM_CLASSES_WITH_CCL = ("PlanarUniformity", "TomographicUniformity", "TomographicContrast")


def write_nm(path: str, frames, pixel_spacing: float, extra: dict | None = None) -> str:
    """A multi-frame NM DICOM of uint16 ``frames``, written with the port's
    DICOM writer."""
    from pylinac_tpu_torch.core import dcm

    ds = dcm.Dataset()
    ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.20"
    ds.SOPInstanceUID = dcm.generate_uid()
    ds.StudyInstanceUID = dcm.generate_uid()
    ds.SeriesInstanceUID = dcm.generate_uid()
    ds.Modality = "NM"
    ds.PatientName = "NM^Smoke"
    ds.PatientID = "NM1"
    ds.PixelSpacing = [pixel_spacing, pixel_spacing]
    for k, v in (extra or {}).items():
        setattr(ds, k, v)
    ds.set_pixel_data(np.clip(np.asarray(frames), 0, 65535).astype(np.uint16))
    dcm.dcmwrite(path, ds)
    return path


def _gauss(shape, centre, sigma, amp):
    grids = np.ogrid[tuple(slice(0, n) for n in shape)]
    r2 = sum(((g - c) / s) ** 2 for g, c, s in zip(grids, centre, sigma))
    return amp * np.exp(-r2 / 2)


def nuclear_inputs(tmp: str) -> dict[str, str]:
    """The phase's NM files, drawn with numpy from seed 16: the flood, the
    COR projections, the point source, the Jaszczak cylinder, the four-bar
    and quadrant frames, the dynamic series and the sensitivity frames."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(16)
    h, w = NM_PLANAR_SHAPE
    rows, cols = int(400 / NM_PLANAR_MM), int(540 / NM_PLANAR_MM)   # a 540 x 400 mm UFOV
    r0, c0 = (h - rows) // 2, (w - cols) // 2
    mean = NM_FLOOD_COUNTS / (rows * cols)
    floods = []
    for dip in (0.0, 0.05):   # the second frame has a 5 % cold spot
        lam = np.zeros((h, w))
        lam[r0:r0 + rows, c0:c0 + cols] = mean
        lam *= 1 - dip * np.exp(-(((np.arange(h)[:, None] - 400) ** 2
                                   + (np.arange(w)[None, :] - 600) ** 2) / (2 * 30 ** 2)))
        floods.append(rng.poisson(lam))
    files = {"flood": write_nm(f"{tmp}/flood.dcm", floods, NM_PLANAR_MM)}

    rot = _nm_rotation("CW", 0.0, NM_COR_STEP)
    n = int(round(360 / NM_COR_STEP))
    cor = [rng.poisson(_gauss((NM_SPECT_SIZE,) * 2,
                              (60.0, NM_COR_AXIS_PX + NM_COR_RADIUS_PX
                               * np.sin(np.radians(-NM_COR_STEP * i))), (1.5, 1.5), 2000.0))
           for i in range(n)]
    files["cor"] = write_nm(f"{tmp}/cor.dcm", cor, NM_COR_MM,
                            {"RotationInformationSequence": rot})

    x, y, z = NM_POINT_XYZ
    sxy, sz = NM_POINT_SIGMA
    point = rng.poisson(_gauss((NM_SPECT_SIZE,) * 3, (z, y, x), (sz, sxy, sxy), 5000.0))
    files["point"] = write_nm(f"{tmp}/point.dcm", point, NM_SPECT_MM,
                              {"SpacingBetweenSlices": NM_SPECT_MM})
    files["jaszczak"] = write_nm(f"{tmp}/jaszczak.dcm", draw_jaszczak(rng), NM_SPECT_MM,
                                 {"SpacingBetweenSlices": NM_SPECT_MM})

    sigma_px = NM_LSF_FWHM_MM / 2.3548 / NM_PLANAR_MM
    yy, xx = np.mgrid[:h, :w]
    bars = np.full((h, w), 20.0)
    for off in (-1, 1):
        c = h / 2 + off * NM_BAR_SEPARATION_MM / 2 / NM_PLANAR_MM
        bars += 400 * np.exp(-((xx - c) ** 2) / (2 * sigma_px ** 2))
        bars += 400 * np.exp(-((yy - c) ** 2) / (2 * sigma_px ** 2))
    files["fourbar"] = write_nm(f"{tmp}/fourbar.dcm", [rng.poisson(bars)], NM_PLANAR_MM,
                                {"Rows": h, "Columns": w})
    quad = np.zeros((h, w))
    for angle, width in zip((45, -45, -135, 135), NM_BAR_WIDTHS):
        rows_q = (yy >= h / 2) if np.sin(np.radians(angle)) > 0 else (yy < h / 2)
        cols_q = (xx >= w / 2) if np.cos(np.radians(angle)) > 0 else (xx < w / 2)
        stripes = (np.floor(xx * NM_PLANAR_MM / width) % 2 == 0)
        quad[rows_q & cols_q & stripes] = 400.0
    quad = gaussian_filter(quad, sigma_px) + 100.0
    files["quad"] = write_nm(f"{tmp}/quad.dcm", [rng.poisson(quad)], NM_PLANAR_MM,
                             {"Rows": h, "Columns": w})

    xr = (np.arange(NM_MCR_FRAMES) + 1) / (NM_MCR_PEAK + 1)
    rate = 200 * xr * np.exp(1 - xr)   # a paralysable camera: the peak at frame 72
    files["mcr"] = write_nm(f"{tmp}/mcr.dcm",
                            rng.poisson(rate[:, None, None] * np.ones((1, 128, 128))), 4.8)
    files["sens"] = write_nm(f"{tmp}/sens.dcm", [rng.poisson(np.full((128, 128), 80.0))], 4.8,
                             {"ActualFrameDuration": 60000})
    files["sens_bg"] = write_nm(f"{tmp}/sens_bg.dcm", rng.poisson(np.full((3, 128, 128), 2.0)),
                                4.8, {"ActualFrameDuration": 60000})
    return files


def _nm_rotation(direction: str, start: float, step: float) -> list:
    from pylinac_tpu_torch.core import dcm

    item = dcm.Dataset()
    item.RotationDirection = direction
    item.StartAngle = start
    item.AngularStep = step
    return [item]


def nm_sphere_centres() -> list[tuple[float, float]]:
    """The drawn spheres' (x, y) px: at 0.65 of the eroded FOV's radius,
    where the analysis starts its search."""
    c = NM_SPECT_SIZE / 2
    radius = 108 / NM_SPECT_MM
    dist = (radius - round(0.2 * 2 * radius) / 2) * 0.65
    return [(c + np.cos(np.radians(a)) * dist, c + np.sin(np.radians(a)) * dist)
            for a, _ in NM_SPHERES]


def draw_jaszczak(rng) -> np.ndarray:
    """A reconstructed Jaszczak cylinder (216 mm, 186 mm tall) in a 128-slice
    volume, its radius jittered a little by slice as a reconstruction's is,
    with the six cold spheres on one slice."""
    n, c = NM_SPECT_SIZE, NM_SPECT_SIZE / 2
    radius = 108 / NM_SPECT_MM
    yy, xx = np.mgrid[:n, :n]
    vol = np.zeros((n, n, n))
    z0, z1 = NM_CYLINDER_SLICES
    for z in range(z0, z1):
        vol[z] = np.where((yy - c) ** 2 + (xx - c) ** 2 < (radius + rng.uniform(-0.3, 0.3)) ** 2,
                          1000.0, 0.0)
    vol += rng.normal(0, 5, vol.shape).clip(-20, 20) * (vol > 0)
    zz, yy3, xx3 = np.ogrid[:n, :n, :n]
    for (cx, cy), (_, diam) in zip(nm_sphere_centres(), NM_SPHERES):
        r = diam / (2 * NM_SPECT_MM)
        vol[(xx3 - cx) ** 2 + (yy3 - cy) ** 2 + (zz - NM_SPHERE_SLICE) ** 2 <= r ** 2] = 300.0
    return vol.clip(0)


def nm_tol(path: str, a: float) -> float:
    """The parity bars: mm 0.01 and % 0.1, other floats 1e-6 relative."""
    key = path.rsplit("/", 1)[-1]
    if any(s in key for s in ("uniformity", "difference", "contrast")) or key == "mtf":
        return PCT_TOL
    if any(s in key for s in ("fwhm", "fwtm", "deviation", "pixel_size")) or \
            key in ("x", "y", "z", "radius", "spacing"):
        return MM_TOL
    return 1e-6 * max(abs(a), 1.0)


def nm_make(name: str, files: dict):
    from pylinac_tpu_torch import nuclear

    if name == "SimpleSensitivity":
        return nuclear.SimpleSensitivity(files["sens"], background_path=files["sens_bg"])
    return getattr(nuclear, name)(files[NM_RUNS[name][0]])


def nm_check(name: str, obj, data: dict, what: str) -> None:
    """The drawn geometry and counts each analysis must find."""
    sigma_mm = NM_LSF_FWHM_MM / 2.3548
    if name == "PlanarUniformity":
        f1, f2 = data["Frame 1"], data["Frame 2"]
        ok = (0 < f1["ufov_integral_uniformity"] < 5
              and f2["ufov_integral_uniformity"] > f1["ufov_integral_uniformity"]
              and obj.frame_results["1"]["binned_frame"].shape == (128, 128))
    elif name == "CenterOfRotation":
        axis_mm = NM_COR_AXIS_PX * NM_COR_MM + NM_COR_MM / 2
        ok = (abs(obj.cor_x["a"] - axis_mm) < 0.05
              and abs(abs(obj.cor_x["b"]) - NM_COR_RADIUS_PX * NM_COR_MM) < 0.1
              and data["x_deviation_mm"] < 0.5 and data["y_deviation_mm"] < 0.5)
    elif name == "TomographicResolution":
        sxy, sz = NM_POINT_SIGMA
        ok = (abs(data["x_fwhm"] / (2.3548 * sxy * NM_SPECT_MM) - 1) < 0.05
              and abs(data["y_fwhm"] / (2.3548 * sxy * NM_SPECT_MM) - 1) < 0.05
              and abs(data["z_fwhm"] / (2.3548 * sz * NM_SPECT_MM) - 1) < 0.05)
    elif name == "TomographicUniformity":
        ok = data["ufov_integral_uniformity"] < 10 and abs(data["center_border_ratio"] - 1) < 0.05
    elif name == "TomographicContrast":
        spheres = data["spheres"]
        # the four spheres of 19 mm and more found at their drawn centres;
        # the search may miss the two smallest (3.6 and 2.9 voxels across)
        ok = (len(spheres) == 6 and spheres["1"]["mean_contrast"] > 40
              and all(np.hypot(s["x"] - cx, s["y"] - cy) < 1.5
                      and abs(s["z"] - NM_SPHERE_SLICE) <= 1
                      for s, (cx, cy) in zip(list(spheres.values())[:4], nm_sphere_centres())))
    elif name == "FourBarResolution":
        ok = all(abs(data[f"{a}_measured_pixel_size"] / NM_PLANAR_MM - 1) < 0.01
                 and abs(data[f"{a}_fwhm"] / (2.3548 * sigma_mm) - 1) < 0.1 for a in "xy")
    elif name == "QuadrantResolution":
        mtfs = [q["mtf"] for q in data["quadrants"].values()]
        ok = all(a > b for a, b in zip(mtfs, mtfs[1:]))
    elif name == "MaxCountRate":
        ok = abs(data["max_frame"] - NM_MCR_PEAK) <= 10
    else:   # SimpleSensitivity: the counts a second of the files, by numpy
        from pylinac_tpu_torch.core import dcm

        cps = float(dcm.dcmread(obj.phantom_path).pixel_array.sum()) / 60
        bg = float(dcm.dcmread(obj.background_path).pixel_array.astype(np.float32)
                   .mean(axis=0).sum()) / 60
        ok = abs(data["phantom_cps"] - cps) < 1e-6 * cps and abs(data["background_cps"] - bg) < 1e-3
    if not ok:
        raise RuntimeError(f"{what}: the drawn truth is not met: {json.dumps(data)[-900:]}")


# class -> (file, analyze arguments)
NM_RUNS = {
    "PlanarUniformity": ("flood", {}),
    "CenterOfRotation": ("cor", {}),
    "TomographicResolution": ("point", {}),
    "TomographicUniformity": ("jaszczak", {"first_frame": 44, "last_frame": 64}),
    "TomographicContrast": ("jaszczak", {}),
    "FourBarResolution": ("fourbar", {"separation_mm": NM_BAR_SEPARATION_MM}),
    "QuadrantResolution": ("quad", {"bar_widths": NM_BAR_WIDTHS}),
    "MaxCountRate": ("mcr", {"frame_duration": 0.5}),
    "SimpleSensitivity": ("sens", {"activity_mbq": 370.0}),
}


def nm_analyze(name: str, obj, device: str) -> dict:
    from pylinac_tpu_torch.nuclear import Nuclide

    kwargs = dict(NM_RUNS[name][1])
    if name == "SimpleSensitivity":
        kwargs["nuclide"] = Nuclide.Tc99m
    obj.analyze(**kwargs, device=device)
    data = obj.results_data(as_dict=True)
    if device == "cuda":
        torch.cuda.synchronize()
    return data


def nuclear_phase(card: str, ccl) -> list[dict]:
    """The nine nuclear-medicine classes on the card at clinical sizes: each
    analysis's CCL launches counted (the region searches of ``get_fov`` and
    of every ``slice_data`` slice, the small-object and small-hole removal;
    128 + 128 for the 128-slice cylinder) and every input held bit-equal to
    the twins, the drawn truths, card against CPU at the bars, warm runs (1,
    then 5 timed, each on a fresh object) equal; the kernels timed at the
    phase's mask shape. Returns the CCL lines."""
    from pylinac_tpu_torch.ops import morphology as tmorph

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nm_")
    try:
        t0 = time.perf_counter()
        files = nuclear_inputs(tmp)
        print(f"inputs: a 2 x {NM_PLANAR_SHAPE[0]} x {NM_PLANAR_SHAPE[1]} flood at "
              f"{NM_PLANAR_MM} mm ({NM_FLOOD_COUNTS:.0e} counts a frame), 120 COR projections "
              f"of 128 x 128 at {NM_COR_MM} mm, a 128^3 point source and a 128-slice Jaszczak "
              f"cylinder at {NM_SPECT_MM} mm, four-bar and quadrant frames, a 120-frame series, "
              f"sensitivity frames; in {time.perf_counter() - t0:.1f} s")
        entries = ccl_entries() + [(tmorph, "label_batch", "label")]
        pairs = kernel_pairs(ccl)
        totals, worst, seen_all = Counter(), {}, []
        for name in NM_RUNS:
            what = f"nuclear {name}"
            ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
            obj = nm_make(name, files)
            with recording_inputs(entries) as seen:
                data = nm_analyze(name, obj, "cuda")
            counts = {"label": ccl.label_batch.launches, "holes": ccl.hole_roots_batch.launches}
            check_counts(seen, counts, what)
            if name in NM_CLASSES_WITH_CCL and min(counts.values()) < 1:
                raise RuntimeError(f"the {what} path launched a CCL mode no time: {counts}")
            if name == "TomographicContrast" and counts != {"label": 128, "holes": 128}:
                raise RuntimeError(f"the {what} slice search launched {counts}, not 128 + 128")
            if seen:
                for mode, e in check_path_masks(pairs, seen, what).items():
                    worst[mode] = max(worst.get(mode, 0.0), e)
            totals.update(counts)
            seen_all += seen
            nm_check(name, obj, data, f"card {what}")
            cpu_obj = nm_make(name, files)
            cpu_data = nm_analyze(name, cpu_obj, "cpu")
            diff = compare_tree(data, cpu_data, f"{what} card vs CPU", nm_tol)
            if name in ("PlanarUniformity", "TomographicUniformity"):
                for key, r in cpu_obj.frame_results.items():
                    for part in ("binned_frame", "ufov", "cfov"):
                        a, b = obj.frame_results[key][part], r[part]
                        a, b = (a, b) if part == "binned_frame" else (a.fov, b.fov)
                        if not np.array_equal(a, b):
                            raise RuntimeError(f"{what}: the card's {part} differs from the CPU's")
            fresh = [nm_make(name, files) for _ in range(WARM_RUNS)]
            warm, outs = median_runs(card, f"warm {name} analyze + results_data",
                                     lambda: nm_analyze(name, fresh.pop(), "cuda"))
            check_same_texts([results_text(o) for o in outs], f"{name} warm runs")
            print(f"{what}: launches {counts}, card vs CPU max difference {diff:.2e}, "
                  f"warm {warm:.1f} ms")
        lines = []
        for mode in ("label", "holes"):
            kernel, twin = pairs[mode]
            masks, args, kwargs = largest_record(seen_all, mode)
            masks = masks if masks.dim() == 3 else masks[None]
            timed = timed_pair(card, f"nuclear {mode}", lambda x: kernel(x, *args, **kwargs),
                               lambda x: twin(x, *args, **kwargs), masks, ccl_bound)
            lines.append(ccl_line(f"ccl_{mode}_nuclear", "pylinac_tpu/ops/pallas_label.py:336",
                                  totals[mode], worst.get(mode, 0.0), timed))
        print(f"nuclear launches: {dict(totals)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


# the machine-log analyzer (log_analyzer.py): a 120-leaf Millennium VMAT arc
LOG_TLOG_SNAPSHOTS = 4000       # 80 s at 20 ms
LOG_DLOG_SNAPSHOTS = 1600       # 80 s at 50 ms
LOG_FOLDER_PAIRS = 10           # 10 trajectory logs and 10 dynalog pairs
LOG_FLUENCE_REL = 1e-6          # card against CPU, of the map's maximum
LOG_PICKETS_MM = tuple(range(-90, 91, 20))


def log_phase(card: str, median) -> int:
    """The log analyzer on the card: a trajectory log and a dynalog pair of
    one VMAT arc, a folder of 20 logs, and ``PicketFence(log=)``. The
    fluence maps card against CPU within 1e-6 of the maximum and bit-equal
    between card runs, RMS and gamma card against CPU, warm ms a log for
    ``calc_map`` and for the gamma, ``interval_fluence`` timed at the
    arc's (60, 4001) and the equal-aspect map's. Returns the median
    launches of ``PicketFence(log=)`` (its de-spike), each input held to
    the twin."""
    from pylinac_tpu_torch import log_analyzer as tl
    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
    from pylinac_tpu_torch.imggen.logs import (
        write_picket_tlog, write_vmat_dynalog_pair, write_vmat_tlog)
    from pylinac_tpu_torch.imggen.simulators import AS1200Image
    from pylinac_tpu_torch.imggen.utils import generate_picketfence
    from pylinac_tpu_torch.ops import filters as tfilters
    from pylinac_tpu_torch.ops.fluence import interval_fluence
    from pylinac_tpu_torch.picketfence import PicketFence

    tmp = tempfile.mkdtemp(prefix="chip_smoke_logs_")
    try:
        t0 = time.perf_counter()
        folder = os.path.join(tmp, "logs")
        os.makedirs(folder)
        tlog = write_vmat_tlog(os.path.join(tmp, "T_arc.bin"), LOG_TLOG_SNAPSHOTS, seed=0)
        dlog = write_vmat_dynalog_pair(tmp, LOG_DLOG_SNAPSHOTS, seed=1)["A"]
        for i in range(LOG_FOLDER_PAIRS):
            write_vmat_tlog(os.path.join(folder, f"T{i}_arc.bin"), LOG_TLOG_SNAPSHOTS,
                            seed=10 + i)
            write_vmat_dynalog_pair(folder, LOG_DLOG_SNAPSHOTS, seed=30 + i, name=f"{i}_arc")
        pf_img = os.path.join(tmp, "pf.dcm")
        generate_picketfence(simulator=AS1200Image(sid=1000), field_layer=PerfectFieldLayer,
                             file_out=pf_img, final_layers=[GaussianFilterLayer(sigma_mm=1)],
                             pickets=len(LOG_PICKETS_MM), picket_spacing_mm=20,
                             picket_width_mm=3)
        pf_log = write_picket_tlog(os.path.join(tmp, "PF_log.bin"), list(LOG_PICKETS_MM))
        print(f"inputs: a {LOG_TLOG_SNAPSHOTS}-snapshot trajectory log and a "
              f"{LOG_DLOG_SNAPSHOTS}-snapshot dynalog pair of one VMAT arc (120 leaves), a "
              f"folder of {LOG_FOLDER_PAIRS} of each, an AS1200 picket fence and its log; in "
              f"{time.perf_counter() - t0:.1f} s")

        for what, path in (("trajectory log", tlog), ("dynalog", dlog)):
            card_log = tl.load_log(path, device="cuda")
            cpu_log = tl.load_log(path, device="cpu")
            maps = [card_log.fluence.actual.calc_map()]
            for _ in range(REPEATS):
                card_log.fluence.actual._cache_key = None
                maps.append(card_log.fluence.actual.calc_map())
            if not all(np.array_equal(m, maps[0]) for m in maps):
                raise RuntimeError(f"the {what}'s card fluence changed between runs")
            cpu_map = cpu_log.fluence.actual.calc_map()
            err = float(np.abs(maps[0] - cpu_map).max())
            if err > LOG_FLUENCE_REL * float(np.abs(cpu_map).max()):
                raise RuntimeError(f"the {what}'s card fluence is {err} off the CPU's")
            g_card = card_log.fluence.gamma.calc_map()
            g_cpu = cpu_log.fluence.gamma.calc_map()
            gerr = float(np.abs(g_card - g_cpu).max())
            gc, gp = card_log.fluence.gamma, cpu_log.fluence.gamma
            if gerr > 1e-5 or abs(gc.pass_prcnt - gp.pass_prcnt) > PCT_TOL \
                    or abs(gc.avg_gamma - gp.avg_gamma) > 1e-5:
                raise RuntimeError(f"the {what}'s card gamma is off the CPU's: max {gerr}, "
                                   f"pass {gc.pass_prcnt} vs {gp.pass_prcnt}")
            mlc = card_log.axis_data.mlc
            rms = (mlc.get_RMS_avg(), mlc.get_RMS_max(), mlc.get_error_percentile(95))
            if rms != (cpu_log.axis_data.mlc.get_RMS_avg(), cpu_log.axis_data.mlc.get_RMS_max(),
                       cpu_log.axis_data.mlc.get_error_percentile(95)) or not 0 < rms[0] < 0.05:
                raise RuntimeError(f"the {what}'s RMS: {rms}")
            print(f"{what}: fluence {maps[0].shape} equal in {REPEATS + 1} card runs, "
                  f"{err:.2e} off the CPU (max {np.abs(cpu_map).max():.4g}); gamma {gerr:.2e} "
                  f"off, avg {gc.avg_gamma:.5f}, pass {gc.pass_prcnt:.2f} %; RMS avg "
                  f"{rms[0] * 10:.4f} mm, max {rms[1] * 10:.4f} mm, 95th error "
                  f"{rms[2] * 10:.4f} mm; treatment {card_log.treatment_type}")

            def fluence_run(eq=False):
                card_log.fluence.actual._cache_key = None
                return card_log.fluence.actual.calc_map(equal_aspect=eq)

            def gamma_run():
                card_log.fluence.gamma._cache_key = None
                return card_log.fluence.gamma.calc_map()

            median_runs(card, f"warm {what} calc_map (60 x 4000 at 0.1 mm)", fluence_run)
            median_runs(card, f"warm {what} gamma (calc_map of the cached maps)", gamma_run)
            median_runs(card, f"warm {what} calc_map(equal_aspect=True) (4000 x 4000)",
                        lambda: fluence_run(True))

        # interval_fluence alone at the arc's shape, by CUDA events
        log = tl.load_log(tlog, device="cuda")
        mlc = log.axis_data.mlc
        snaps = np.asarray(mlc.snapshot_idx)
        P, S = mlc.num_pairs, len(snaps)
        rng = np.random.default_rng(3)
        left = torch.as_tensor(rng.integers(0, 2000, (P, S)), dtype=torch.int32, device="cuda")
        right = (left + torch.as_tensor(rng.integers(0, 2000, (P, S)), dtype=torch.int32,
                                        device="cuda")).clamp(max=4000)
        mu = torch.rand(S, device="cuda")
        blocked = torch.zeros(P, dtype=torch.bool, device="cuda")
        ms = time_ms(lambda _: interval_fluence(left, right, mu, blocked, 4000), left, 20)
        print(f"[{card}] interval_fluence at ({P}, {S}) snapshots -> ({P}, 4001): {ms:.3f} ms "
              f"a call (CUDA events, mean of 20)")

        logs = tl.MachineLogs(folder, device="cuda")
        cpu_logs = tl.MachineLogs(folder, device="cpu")
        if (logs.num_tlogs, logs.num_dlogs) != (LOG_FOLDER_PAIRS, LOG_FOLDER_PAIRS):
            raise RuntimeError(f"the folder read {logs.num_tlogs} + {logs.num_dlogs} logs")
        t0 = time.perf_counter()
        avg, pct = logs.avg_gamma(), logs.avg_gamma_pct()
        torch.cuda.synchronize()
        folder_ms = (time.perf_counter() - t0) * 1e3
        cavg, cpct = cpu_logs.avg_gamma(), cpu_logs.avg_gamma_pct()
        if abs(avg - cavg) > 1e-5 or abs(pct - cpct) > PCT_TOL:
            raise RuntimeError(f"the folder's gamma: card {avg}, {pct} vs CPU {cavg}, {cpct}")
        print(f"[{card}] MachineLogs of {logs.num_logs} logs: avg_gamma {avg:.5f} and "
              f"avg_gamma_pct {pct:.3f} (CPU {cavg:.5f}, {cpct:.3f}) in {folder_ms:.1f} ms, "
              f"{folder_ms / logs.num_logs:.1f} ms a log (maps and gamma)")

        median.median3x3.launches = 0
        with recording_inputs([(tfilters, "median3x3", "median")]) as seen:
            pf = PicketFence(pf_img, log=pf_log, device="cuda")
            pf.analyze()
            data = pf.results_data(as_dict=True)
        torch.cuda.synchronize()
        launches = median.median3x3.launches
        # the de-spike fires only on a noisy frame; whatever it launched is
        # held to the twin before its launches join the median entry
        check_counts(seen, {"median": launches}, "PicketFence(log=) run")
        if seen:
            check_path_masks({"median": (median.median3x3, median.median3x3_reference)}, seen,
                             "PicketFence(log=) run")
        cpu_pf = PicketFence(pf_img, log=pf_log, device="cpu")
        cpu_pf.analyze()
        diff = compare_tree(data, cpu_pf.results_data(as_dict=True), "PicketFence(log=) card "
                            "vs CPU", lambda p, a: MM_TOL)
        if data["number_of_pickets"] != len(LOG_PICKETS_MM) or data["max_error_mm"] > 0.5:
            raise RuntimeError(f"PicketFence(log=): {data['number_of_pickets']} pickets, max "
                               f"error {data['max_error_mm']} mm against the log's fits")
        def pf_run():
            obj = PicketFence(pf_img, log=pf_log, device="cuda")
            obj.analyze()
            out = obj.results_data(as_dict=True)
            torch.cuda.synchronize()
            return out

        _, outs = median_runs(card, "warm PicketFence(log=) construction (the log's fluence, "
                              "its picket fence) + analyze + results_data", pf_run)
        check_same_texts([results_text(o) for o in outs], "PicketFence(log=) warm runs")
        print(f"PicketFence(log=): {data['number_of_pickets']} pickets, max error "
              f"{data['max_error_mm']:.4f} mm against the log's fits, card vs CPU max difference "
              f"{diff:.2e}, median3x3 launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# QA plans and their fluence (plan_generator/), the contributed analyses
# (contrib/) and the calibration worksheets (calibration/)
PLAN_HOT_PIXELS = 1e-4          # the smoke's 0.01 % hot pixels on the rendered fence
PLAN_PICKETS = 7                # add_picketfence_beam's default strips
PLAN_TRUTH_MM = 0.5             # tests/models/test_plan_generator.py:253
JAW_FIELD_MM = 150
JAW_DEG = 0.5                   # tests/models/test_contrib.py:26
QUASAR_CORNERS = ((-49, -49), (-49, 49), (49, -49), (49, 49))
QUASAR_SCALING = ((0, 0), (-12, 0), (12, 0), (0, -12), (0, 12))
PLAN_WARM_RUNS = 4              # 1 warm-up, then the median of 3


def plan_template(machine: str):
    """A template RT plan written with the port's own codec: a TrueBeam
    with the Millennium or the HD120 MLC, or a Halcyon's two stacks."""
    from pylinac_tpu_torch.core import dcm as tdcm
    from pylinac_tpu_torch.plan_generator import dicom as tdicom

    stacks = {"millennium": [("MLCX", 60, tdicom.MLC_MILLENNIUM_BOUNDARIES)],
              "hd": [("MLCX", 60, tdicom.MLC_120HDMIL_BOUNDARIES)],
              "halcyon": [("MLCX1", 28, tdicom.MLC_DISTAL_BOUNDARIES),
                          ("MLCX2", 29, tdicom.MLC_PROXIMAL_BOUNDARIES)]}[machine]
    ds = tdcm.Dataset()
    ds.SOPClassUID = "1.2.840.10008.5.1.4.1.1.481.5"
    ds.SOPInstanceUID = tdcm.generate_uid()
    ds.Modality = "RTPLAN"
    ds.PatientName = "QA^Physics"
    ds.PatientID = "QA123"
    ds.RTPlanLabel = "template"
    tol = tdcm.Dataset()
    tol.ToleranceTableNumber = 1
    ds.ToleranceTableSequence = [tol]
    beam = tdcm.Dataset()
    beam.TreatmentMachineName = "HAL01" if machine == "halcyon" else "TB01"
    beam.BeamLimitingDeviceSequence = []
    for kind, pairs, bounds in stacks:
        mlc = tdcm.Dataset()
        mlc.RTBeamLimitingDeviceType = kind
        mlc.NumberOfLeafJawPairs = pairs
        mlc.LeafPositionBoundaries = bounds
        beam.BeamLimitingDeviceSequence.append(mlc)
    ds.BeamSequence = [beam]
    return ds


def qa_plans() -> dict:
    """Every TrueBeam QA beam on a Millennium and an HD template, a Halcyon
    dual-stack picket fence, and a picket-fence-only plan to render."""
    import pylinac_tpu_torch as p
    from pylinac_tpu_torch.plan_generator import Stack

    plans = {}
    for machine in ("millennium", "hd"):
        g = p.TrueBeamPlanGenerator(plan_template(machine), plan_label="QA",
                                    plan_name=f"QA {machine}")
        g.add_picketfence_beam()
        g.add_mlc_transmission(bank="A")
        g.add_mlc_transmission(bank="B")
        g.add_dose_rate_beams()
        g.add_mlc_speed_beams()
        g.add_winston_lutz_beams()
        g.add_gantry_speed_beams()
        g.add_open_field_beam(x1=-50, x2=50, y1=-50, y2=50)
        plans[machine] = g
    plans["halcyon"] = p.HalcyonPlanGenerator(plan_template("halcyon"), plan_label="QA",
                                              plan_name="QA halcyon")
    plans["halcyon"].add_picketfence_beam(stack=Stack.BOTH)
    plans["pf"] = p.TrueBeamPlanGenerator(plan_template("millennium"), plan_label="QA",
                                          plan_name="QA PF")
    plans["pf"].add_picketfence_beam()
    return plans


def draw_quasar(path: str) -> str:
    """The Quasar frame of ``tests/models/test_contrib.py:30-50`` on an
    AS1200: a 120 mm field, four BBs 11 mm inside its edges and five
    central scaling BBs."""
    from pylinac_tpu_torch.imggen.layers import (FilteredFieldLayer, GaussianFilterLayer,
                                                 PerfectBBLayer)
    from pylinac_tpu_torch.imggen.simulators import AS1200Image

    sim = AS1200Image(sid=1000)
    sim.add_layer(FilteredFieldLayer(field_size_mm=(120, 120)))
    for pos in QUASAR_CORNERS + QUASAR_SCALING:
        sim.add_layer(PerfectBBLayer(bb_size_mm=5, cax_offset_mm=pos))
    sim.add_layer(GaussianFilterLayer(sigma_mm=0.5))
    sim.generate_dicom(path)
    return path


def calibration_checks(card: str, tmp: str) -> None:
    """The TG-51 photon, both TG-51 electron and both TRS-398 worksheets on
    the host, each PDF written and read back: ``%PDF`` and one page."""
    from pylinac_tpu_torch import tg51, trs398

    common = dict(temp=22.5, press=100.8, n_dw=5.443, voltage_reference=-300,
                  voltage_reduced=-150, m_reference=(25.65, 25.66), m_opposite=(-25.71, -25.70),
                  m_reduced=(25.59, 25.60), mu=200)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # TRS-398's k_tp warns of its 20 degree reference
        sheets = {
            "TG51Photon": (tg51.TG51Photon(
                **common, unit="TB1", chamber="30013", p_elec=1.0, measured_pdd10=66.4,
                clinical_pdd10=66.5, energy=6), "dose_mu_dmax"),
            "TG51ElectronLegacy": (tg51.TG51ElectronLegacy(
                **common, chamber="30013", k_ecal=0.906, p_elec=1.0, clinical_pdd=99.5,
                m_gradient=(25.7, 25.71), i_50=4.8), "dose_mu_dmax"),
            "TG51ElectronModern": (tg51.TG51ElectronModern(
                **common, chamber="A12", p_elec=1.0, clinical_pdd=100.0, i_50=3.6),
                "dose_mu_dmax"),
            "TRS398Photon": (trs398.TRS398Photon(
                **common, setup="SSD", chamber="30013", tpr2010=0.671, k_elec=1.0,
                clinical_pdd_zref=66.7), "dose_mu_zmax"),
            "TRS398Electron": (trs398.TRS398Electron(
                **common, chamber="30013", i_50=4.8, k_elec=1.0, clinical_pdd_zref=99.0),
                "dose_mu_zmax"),
        }
        doses = {}
        for name, (sheet, dose) in sheets.items():
            path = os.path.join(tmp, f"{name}.pdf")
            sheet.publish_pdf(path, notes="smoke")
            data = open(path, "rb").read()
            doses[name] = getattr(sheet, dose)
            if not data.startswith(b"%PDF") or b"/Count 1 " not in data:
                raise RuntimeError(f"{name}'s PDF: {data[:8]!r}, page count not 1")
            if not 0.5 < doses[name] < 1.5:
                raise RuntimeError(f"{name}: {dose} {doses[name]} cGy/MU")
    print(f"[{card}] calibration worksheets (host) with their PDFs, one page each, in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms: "
          + ", ".join(f"{k} {v:.4f} cGy/MU" for k, v in doses.items()))


def plan_phase(card: str, median, ccl) -> list[dict]:
    """QA plans, their fluence and the contributed analyses on the card:
    every TrueBeam QA beam on a Millennium and an HD template and a Halcyon
    picket fence, each written and read back; ``generate_fluences`` of each
    on the card at AS1200's grid and at 0.1 mm over 400 mm, equal to the CPU
    in float32 and uint16; the picket fence plan rendered on an AS1200
    (``to_dicom_images``, equal to the CPU's), 0.01 % hot pixels added and
    analysed by ``PicketFence`` with its de-spike's ``median3x3`` launches
    counted (7 pickets, within 0.5 mm of the plan, against the CPU);
    ``JawOrthogonality`` of an AS1200 150 mm field (Canny's hysteresis on
    ``ccl.cu``; edge map and Hough accumulator equal to the CPU's, every
    corner within 0.5 degrees of 90); ``QuasarLightRadScaling`` on an
    AS1200 frame (medians and BB windows on the kernels, against the CPU,
    the scaling centres within 1e-3 px); every kernel input held bit-equal
    to its twin; warm runs timed; the calibration worksheets and their
    PDFs; whether matplotlib imports. Returns the phase's kernel lines."""
    import pylinac_tpu_torch as p
    from pylinac_tpu_torch.contrib.orthogonality import JawOrthogonality
    from pylinac_tpu_torch.contrib.quasar import QuasarLightRadScaling
    from pylinac_tpu_torch.core import dcm as tdcm
    from pylinac_tpu_torch.core.array_utils import stretch
    from pylinac_tpu_torch.imggen.layers import FilteredFieldLayer, GaussianFilterLayer
    from pylinac_tpu_torch.imggen.simulators import AS1200Image
    from pylinac_tpu_torch.ops import edges as tedges
    from pylinac_tpu_torch.ops import filters as tfilters
    from pylinac_tpu_torch.planar_imaging import hough_line
    from pylinac_tpu_torch.picketfence import PicketFence

    try:
        import matplotlib
        print(f"matplotlib {matplotlib.__version__} imports on this machine")
    except ImportError as e:
        print(f"matplotlib does not import on this machine: {e}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plan_")
    try:
        t0 = time.perf_counter()
        plans = qa_plans()
        for name, g in plans.items():
            path = os.path.join(tmp, f"{name}.dcm")
            g.to_file(path)
            back = type(g).from_rt_plan_file(path, plan_label="QA", plan_name="back")
            again = io.BytesIO()
            tdcm.dcmwrite(again, tdcm.dcmread(path))
            names = [str(b.BeamName) for b in g.as_dicom().BeamSequence]
            if again.getvalue() != open(path, "rb").read() or \
                    [str(b.BeamName) for b in tdcm.dcmread(path).BeamSequence] != names:
                raise RuntimeError(f"the {name} plan does not read back as written")
            if back.machine_name != g.machine_name:
                raise RuntimeError(f"the {name} plan as a template names another machine")
            print(f"plan {name}: {len(names)} beams ({', '.join(names)}), "
                  f"{os.path.getsize(path)} bytes, written and read back equal")
        print(f"plans built, written and read back in {time.perf_counter() - t0:.1f} s")

        sim = AS1200Image(sid=1000)
        grids = {"AS1200": (sim.shape[1] * sim.pixel_size, sim.pixel_size),
                 "0.1 mm over 400 mm": (400, 0.1)}
        for name in ("millennium", "hd", "halcyon"):
            rt_plan = plans[name].as_dicom()
            for grid, (width, res) in grids.items():
                for dtype in (np.float32, np.uint16):
                    t1 = time.perf_counter()
                    card_map = p.generate_fluences(rt_plan, width, res, dtype=dtype, device="cuda")
                    card_ms = (time.perf_counter() - t1) * 1e3
                    cpu_map = p.generate_fluences(rt_plan, width, res, dtype=dtype,
                                                  device="cpu")
                    if card_map.shape != cpu_map.shape or \
                            not np.array_equal(card_map.view(np.uint8), cpu_map.view(np.uint8)):
                        raise RuntimeError(f"the {name} plan's {np.dtype(dtype).name} fluence "
                                           f"at {grid} differs between the card and the CPU")
                    if not card_map.any():
                        raise RuntimeError(f"the {name} plan's fluence at {grid} is empty")
                print(f"[{card}] generate_fluences of the {name} plan at {grid}: "
                      f"{card_map.shape}, float32 and uint16 equal to the CPU's (uint16 "
                      f"first call {card_ms:.1f} ms)")
            width, res = grids["AS1200"]
            median_runs(card, f"warm generate_fluences of the {name} plan "
                        f"({len(rt_plan.BeamSequence)} beams) at AS1200's grid",
                        lambda: p.generate_fluences(rt_plan, width, res, device="cuda"),
                        PLAN_WARM_RUNS)

        card_imgs = plans["pf"].to_dicom_images(AS1200Image, device="cuda")
        cpu_imgs = plans["pf"].to_dicom_images(AS1200Image, device="cpu")
        frame = card_imgs[0].pixel_array
        if not np.array_equal(frame, cpu_imgs[0].pixel_array) or frame.shape != sim.shape:
            raise RuntimeError("to_dicom_images: the card's frame differs from the CPU's")
        median_runs(card, "warm to_dicom_images of the picket fence plan (AS1200)",
                    lambda: plans["pf"].to_dicom_images(AS1200Image, device="cuda"),
                    PLAN_WARM_RUNS)
        rng = np.random.default_rng(17)
        spiked = frame.copy()
        spiked.flat[rng.choice(spiked.size, int(spiked.size * PLAN_HOT_PIXELS),
                               replace=False)] = 65535
        card_imgs[0].set_pixel_data(spiked)
        pf_path = os.path.join(tmp, "pf_epid.dcm")
        tdcm.dcmwrite(pf_path, card_imgs[0])

        median.median3x3.launches = 0
        with recording_inputs([(tfilters, "median3x3", "median")]) as pf_seen:
            pf = PicketFence(pf_path, device="cuda")
            pf.analyze()
            pf_data = pf.results_data(as_dict=True)
        torch.cuda.synchronize()
        pf_launches = median.median3x3.launches
        check_counts(pf_seen, {"median": pf_launches}, "plan-rendered PicketFence")
        if pf_launches < 1:
            raise RuntimeError("the plan-rendered PicketFence launched no median3x3 kernel")
        cpu_pf = PicketFence(pf_path, device="cpu")
        cpu_pf.analyze()
        pf_diff = compare_tree(result_dict(pf), result_dict(cpu_pf),
                               "plan-rendered PicketFence card vs CPU",
                               lambda path, a: MM_TOL if "mm" in path else PCT_TOL)
        if pf_data["number_of_pickets"] != PLAN_PICKETS or \
                not pf_data["max_error_mm"] < PLAN_TRUTH_MM:
            raise RuntimeError(f"plan-rendered PicketFence: {pf_data['number_of_pickets']} "
                               f"pickets, max error {pf_data['max_error_mm']} mm")
        print(f"plan-rendered PicketFence: {pf_data['number_of_pickets']} pickets, max error "
              f"{pf_data['max_error_mm']:.2e} mm, median3x3 launches {pf_launches}, card vs CPU "
              f"max difference {pf_diff:.2e}")

        def pf_run():
            obj = PicketFence(pf_path, device="cuda")
            obj.analyze()
            out = obj.results_data(as_dict=True)
            torch.cuda.synchronize()
            return out

        _, outs = median_runs(card, "warm plan-rendered PicketFence (load, de-spike, analyze, "
                              "results_data)", pf_run, PLAN_WARM_RUNS)
        check_same_texts([results_text(o) for o in outs], "plan-rendered PicketFence warm runs")

        jaw_path = os.path.join(tmp, "jaw.dcm")
        sim = AS1200Image(sid=1000)
        sim.add_layer(FilteredFieldLayer(field_size_mm=(JAW_FIELD_MM, JAW_FIELD_MM)))
        sim.add_layer(GaussianFilterLayer(sigma_mm=0.5))
        sim.generate_dicom(jaw_path)
        entries = ccl_entries() + [(tedges, "label_batch", "label"),
                                   (tfilters, "median3x3", "median")]
        median.median3x3.launches = 0
        ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
        with recording_inputs(entries) as jaw_seen:
            jaw = JawOrthogonality(jaw_path)
            jaw.analyze(device="cuda")
        jaw_counts = {"label": ccl.label_batch.launches, "holes": ccl.hole_roots_batch.launches,
                      "median": median.median3x3.launches}
        check_counts(jaw_seen, jaw_counts, "JawOrthogonality")
        if jaw_counts["label"] < 1:
            raise RuntimeError(f"JawOrthogonality launched no CCL label kernel: {jaw_counts}")
        cpu_jaw = JawOrthogonality(jaw_path)
        cpu_jaw.analyze(device="cpu")
        if not (np.array_equal(jaw.edge_image, cpu_jaw.edge_image)
                and np.array_equal(jaw.hspace, cpu_jaw.hspace)
                and jaw.results() == cpu_jaw.results()):
            raise RuntimeError("JawOrthogonality: the card's edges, Hough space or angles "
                               "differ from the CPU's")
        angles = jaw.results()
        if not all(abs(a - 90) <= JAW_DEG for a in angles.values()):
            raise RuntimeError(f"JawOrthogonality: corners {angles}")
        print(f"JawOrthogonality of an AS1200 {JAW_FIELD_MM} mm field: "
              f"{int(jaw.edge_image.sum())} edge pixels, Hough {jaw.hspace.shape}, corners "
              + ", ".join(f"{k} {v:.2f}" for k, v in angles.items())
              + f" degrees; launches {jaw_counts}; edges, Hough space and angles equal to the "
                "CPU's")
        edge_input = torch.from_numpy(stretch(jaw.image.array).astype(np.float32)).to("cuda")

        canny_ms, _ = median_runs(card, "warm Canny of the AS1200 frame (to the host)",
                                  lambda: tedges.canny(edge_input).cpu().numpy(),
                                  PLAN_WARM_RUNS)
        theta = np.linspace(-np.pi / 2, np.pi / 2, num=3600, endpoint=False)
        hough_ms, _ = median_runs(card, f"warm hough_line of {int(jaw.edge_image.sum())} edge "
                                  "pixels x 3600 angles (host, bincount)",
                                  lambda: hough_line(jaw.edge_image, theta), PLAN_WARM_RUNS)

        def jaw_run():
            obj = JawOrthogonality(jaw_path)
            obj.analyze(device="cuda")
            return obj.results()

        jaw_ms, _ = median_runs(card, "warm JawOrthogonality (load, Canny, Hough, peaks)",
                                jaw_run, PLAN_WARM_RUNS)

        q_path = draw_quasar(os.path.join(tmp, "quasar.dcm"))
        median.median3x3.launches = 0
        ccl.label_batch.launches = ccl.hole_roots_batch.launches = 0
        with recording_inputs(entries) as q_seen:
            quasar = QuasarLightRadScaling(q_path)
            quasar.analyze(device="cuda")
            q_data = result_dict(quasar)
        torch.cuda.synchronize()
        q_counts = {"label": ccl.label_batch.launches, "holes": ccl.hole_roots_batch.launches,
                    "median": median.median3x3.launches}
        check_counts(q_seen, q_counts, "QuasarLightRadScaling")
        if min(q_counts.values()) < 1:
            raise RuntimeError(f"QuasarLightRadScaling launched a kernel no time: {q_counts}")
        cpu_q = QuasarLightRadScaling(q_path)
        cpu_q.analyze(device="cpu")
        q_diff = compare_tree(q_data, result_dict(cpu_q), "Quasar card vs CPU", planar_tol)
        gaps = [max(abs(a.x - b.x), abs(a.y - b.y))
                for a, b in zip(quasar.scaling_centers, cpu_q.scaling_centers)]
        if len(quasar.scaling_centers) != 5 or max(gaps) > PX_TOL:
            raise RuntimeError(f"Quasar scaling centres: {len(quasar.scaling_centers)}, card "
                               f"vs CPU {gaps} px")
        if abs(q_data["field_size_x_mm"] - 120) > 2 or abs(q_data["field_bb_offset_x_mm"]) > 1.5:
            raise RuntimeError(f"Quasar: {q_data}")
        print(f"QuasarLightRadScaling on AS1200: field {q_data['field_size_x_mm']:.3f} x "
              f"{q_data['field_size_y_mm']:.3f} mm, BB offset "
              f"({q_data['field_bb_offset_x_mm']:.4f}, {q_data['field_bb_offset_y_mm']:.4f}) "
              f"mm, 5 scaling centres within {max(gaps):.2e} px of the CPU's; launches "
              f"{q_counts}; card vs CPU max difference {q_diff:.2e}")

        def quasar_run():
            obj = QuasarLightRadScaling(q_path)
            obj.analyze(device="cuda")
            out = obj.results_data()
            torch.cuda.synchronize()
            return out

        _, outs = median_runs(card, "warm QuasarLightRadScaling (load, analyze, results_data)",
                              quasar_run, PLAN_WARM_RUNS)
        check_same_texts([results_text(o) for o in outs], "Quasar warm runs")

        seen = pf_seen + jaw_seen + q_seen
        pairs = {**kernel_pairs(ccl), "median": (median.median3x3, median.median3x3_reference)}
        worst = check_path_masks(pairs, seen, "plan and contrib")
        totals = Counter({"median": pf_launches})
        totals.update(jaw_counts)
        totals.update(q_counts)
        lines = []
        for mode in ("label", "holes"):
            kernel, twin = pairs[mode]
            masks, args, kwargs = largest_record(seen, mode)
            masks = masks if masks.dim() == 3 else masks[None]
            timed = timed_pair(card, f"contrib ccl {mode}", lambda x: kernel(x, *args, **kwargs),
                               lambda x: twin(x, *args, **kwargs), masks, ccl_bound)
            lines.append(ccl_line(f"ccl_{mode}_contrib", "pylinac_tpu/ops/pallas_label.py:"
                                  + ("127" if mode == "label" else "289"),
                                  totals[mode], worst.get(mode, 0.0), timed))
        x = largest_record(pf_seen, "median")[0].to(torch.float32)
        kernel_ms, plain_ms = time_pair(median.median3x3, median.median3x3_reference, x, 50, 3)
        bound_ms, bound_by = bound(8 * x.numel(), 21 * x.numel(), F32_INSTR_PER_S)
        print(f"[{card}] median3x3 at {tuple(x.shape)}, the plan-rendered frame: kernel "
              f"{kernel_ms:.4f} ms, plain twin {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by})")
        lines.append({"name": "median3x3_contrib", "route": "cuda",
                      "source": "pylinac_tpu_torch/csrc/median3x3.cu",
                      "replaces": "pylinac_tpu/ops/pallas_median.py:27",
                      "launches": totals["median"], "max_abs_err": worst.get("median", 0.0),
                      "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None})
        print(f"[{card}] JawOrthogonality split: Canny {canny_ms:.1f} ms, Hough {hough_ms:.1f} "
              f"ms, whole {jaw_ms:.1f} ms")
        print(f"plan and contrib launches: {dict(totals)}")
        calibration_checks(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


# the mesh phase's layouts on one card: JAX's make_mesh() over every card,
# and two logical meshes, an even and an uneven one
MESH_LOGICAL = (4, 3)
# 1 warm-up, then the median of 2, each layout's runs together: a layout's
# chunk sizes differ from the last one's, and its first run regrows the
# caching allocator's blocks
MESH_WARM_RUNS = 3
WL_PX_TOL = 1e-3          # WL centroids where the shards' sums round otherwise
# what earlier phases keep for the mesh phase: the PF batch of 64 frames,
# the CatPhan batch of 4 scans and the single scan on the card and the CPU
KEPT: dict = {}


WL_SUMS = ("field y", "field x", "BB mass", "BB y", "BB x")


def wl_sum_split(frames: np.ndarray, device, shards: int, bb_window_px: int = 24) -> dict:
    """Which float32 sum makes ``sharded_wl_centroids`` on ``shards`` shards
    differ from its 1-shard run. The steps of ``parallel/mesh.py``'s
    ``sharded_wl_centroids`` run on the whole batch, each of its five float
    sums (``WL_SUMS``; the field's mass counts a bool and is exact) taken
    over the whole batch or shard by shard and joined. Returns, for no sum
    split, every sum split, and each sum split alone, the (N, 4) centroids,
    and for the BB x numerator alone the per-image sums at B = N, N/shards
    and 1."""
    from pylinac_tpu_torch.ops.label import fill_holes

    img = torch.as_tensor(frames, device=device).to(torch.float32)
    img = img - img.amin(dim=(1, 2), keepdim=True)
    _, h, w = img.shape
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    peak = img.amax(dim=(1, 2), keepdim=True)
    field = fill_holes(img > 0.5 * peak)
    fmass = field.sum(dim=(1, 2)).to(torch.float32).clamp(min=1.0)

    def centroids(split):
        def total(name, x):
            if name in split:
                return torch.cat([c.sum(dim=(1, 2)) for c in x.chunk(shards)])
            return x.sum(dim=(1, 2))

        fy = total("field y", field * yy) / fmass
        fx = total("field x", field * xx) / fmass
        inv = torch.where(field, peak - img, 0.0)
        in_win = (((yy - fy[:, None, None]).abs() <= bb_window_px)
                  & ((xx - fx[:, None, None]).abs() <= bb_window_px))
        floor = torch.where(in_win, inv, float("inf")).amin(dim=(1, 2), keepdim=True)
        wgt = torch.where(in_win, (inv - floor).clamp(min=0.0), 0.0)
        bmass = total("BB mass", wgt).clamp(min=1e-6)
        by = total("BB y", wgt * yy) / bmass
        bx = total("BB x", wgt * xx) / bmass
        return torch.stack([fy, fx, by, bx], dim=1), wgt * xx

    out = {"none": centroids(())[0], "all": centroids(WL_SUMS)[0]}
    for name in WL_SUMS:
        out[name] = centroids((name,))[0]
    numer = centroids(())[1]
    out["BB x numerator by batch size"] = {
        b: torch.cat([c.sum(dim=(1, 2)) for c in numer.split(b)])
        for b in (numer.shape[0], numer.shape[0] // shards, 1)}
    return out


def wl_split_report(frames: np.ndarray, mesh_result, plain_result, shards: int) -> str:
    """:func:`wl_sum_split` on the card, held to the real runs: no sum split
    must equal the 1-shard result and every sum split the ``shards``-shard
    one bit for bit; then what each sum split alone moves, by column."""
    parts = wl_sum_split(frames, mesh_result.device, shards)
    for key, real in (("none", plain_result), ("all", mesh_result)):
        if not torch.equal(parts[key], real):
            raise RuntimeError(f"wl_sum_split({key!r}) is not the real run: max |diff| "
                               f"{float((parts[key] - real).abs().max())}")

    def cols(a):
        return [float(v) for v in (a - parts["none"]).abs().amax(dim=0)]

    sums = parts["BB x numerator by batch size"]
    big = sums[max(sums)]
    return ("sums split shard by shard, max |diff| from the 1-shard run by column "
            "(field y, field x, BB y, BB x): "
            + "; ".join(f"{k} {cols(parts[k])}" for k in ("all",) + WL_SUMS)
            + "; the BB x numerator sum(wgt * xx) per image at batch size "
            + ", ".join(f"{b}: max |diff| {float((s - big).abs().max())} of "
                        f"{float(big.abs().max()):.6e}" for b, s in sums.items()))


def mesh_layouts() -> dict:
    from pylinac_tpu_torch.parallel import mesh as tmesh

    first = torch.device("cuda", 0)
    layouts = {"make_mesh()": tmesh.make_mesh()}
    for n in MESH_LOGICAL:
        layouts[f"{n} x {first}"] = tmesh.Mesh([first] * n, ("data",))
    return layouts


def array_tree_diff(a, b, path: str = "") -> tuple[bool, float, str]:
    """Two trees of arrays (dicts of arrays, arrays, tensors): (bit-equal,
    largest float difference, the first non-float field that differs or
    "")."""
    if isinstance(a, dict):
        if list(a) != list(b):
            return False, float("inf"), f"{path} keys"
        parts = [array_tree_diff(a[k], b[k], f"{path}/{k}") for k in a]
        return (all(p[0] for p in parts), max((p[1] for p in parts), default=0.0),
                next((p[2] for p in parts if p[2]), ""))
    x = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    y = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if x.shape != y.shape:
        return False, float("inf"), f"{path} shape"
    if x.dtype.kind != "f":
        same = np.array_equal(x, y)
        return same, 0.0, "" if same else path
    nan = np.isnan(x)
    if not np.array_equal(nan, np.isnan(y)):
        return False, float("inf"), f"{path} NaN mask"
    diff = float(np.max(np.abs(x[~nan].astype(np.float64) - y[~nan]), initial=0.0))
    return bool(np.array_equal(x[~nan], y[~nan])), diff, ""


def hold_mesh_result(got, want, what: str, bar: float) -> str:
    """The mesh's result against the unsharded one: bit-equal, or floats
    within ``bar`` (and every other field equal), which is printed, not
    hidden."""
    same, diff, field = array_tree_diff(got, want)
    if field or diff > bar:
        raise RuntimeError(f"{what}: differs from the unsharded run ({field or 'floats'}, max "
                           f"|diff| {diff}, bar {bar})")
    return "bit-equal" if same else f"floats within {diff:.3e} of it (bar {bar}; not bit-equal)"


def mesh_runs(card: str, what: str, layouts: dict, run_plain, run_mesh, hold,
              entries, counters: dict, min_per_shard: dict) -> dict:
    """``run_plain()`` once, then ``run_mesh(mesh)`` on each layout with every
    launch count at 0 and every kernel input recorded; the recorded inputs
    must match the counts, each mode must launch at least its
    ``min_per_shard`` times the shards, and ``hold(result, unsharded
    result, what)`` must pass (a float: :func:`hold_mesh_result` at that
    bar). Then the warm runs, unsharded and on each mesh, one layout after
    the other. Returns {layout: (counts, recorded inputs)}."""
    if not callable(hold):
        hold = functools.partial(hold_mesh_result, bar=hold)
    want = run_plain()
    torch.cuda.synchronize()
    out = {}
    for name, mesh in layouts.items():
        for counter in counters.values():
            counter.launches = 0
        with recording_inputs(entries) as seen:
            got = run_mesh(mesh)
        torch.cuda.synchronize()
        counts = {mode: counter.launches for mode, counter in counters.items()}
        check_counts(seen, counts, f"{what} on {name}")
        shards = mesh.shape["data"]
        low = {m: c for m, c in counts.items() if c < min_per_shard.get(m, 0) * shards}
        if low:
            raise RuntimeError(f"{what} on {name} ({shards} shards) launched too few kernels: "
                               f"{low}")
        held = hold(got, want, f"{what} on {name}")
        print(f"{what} on {name} ({shards} shards): launches {counts}, result {held}")
        out[name] = (counts, seen)
    runs = {"unsharded": run_plain, **{n: functools.partial(run_mesh, m)
                                       for n, m in layouts.items()}}
    walls = {n: [] for n in runs}
    for n, run in runs.items():
        for _ in range(MESH_WARM_RUNS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls[n].append((time.perf_counter() - t0) * 1e3)
    print(f"[{card}] warm {what}, median of {MESH_WARM_RUNS - 1} runs after one (ms): "
          + ", ".join(f"{n} {statistics.median(w[1:]):.1f} (runs "
                      f"{', '.join(f'{t:.1f}' for t in w[1:])})" for n, w in walls.items()))
    return out


def mesh_kernel_line(card: str, name: str, source: str, replaces: str, mode: str, runs: dict,
                     pairs: dict, bound_) -> dict:
    """The kernels-line entry of a mode on the meshes: every recorded input
    of every layout held bit-equal to its twin, the launches of the 4-shard
    layout, kernel and twin timed on that layout's largest input."""
    worst = 0.0
    for layout, (_, seen) in runs.items():
        mine = [s for s in seen if s[0] == mode]
        worst = max(worst, check_path_masks(pairs, mine, f"{name} on {layout}").get(mode, 0.0))
    layout = next(n for n in runs if n.startswith(f"{MESH_LOGICAL[0]} x"))
    counts, seen = runs[layout]
    _, x, args, kwargs = max((s for s in seen if s[0] == mode), key=lambda s: s[1].numel())
    kernel, twin = pairs[mode]
    x = x if x.dim() == 3 else x[None]
    timed = timed_pair(card, f"{name} ({counts[mode]} launches on {layout})",
                       lambda t: kernel(t, *args, **kwargs), lambda t: twin(t, *args, **kwargs),
                       x, lambda t: bound_(t, args))
    ms, plain_ms, bound_ms, bound_by = timed
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[mode], "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def frozen_reports(obj, tmp: str, tag: str) -> dict:
    """The PDF bytes, the QuAAC JSON and the plotly JSON of an analysis, the
    clocks of ``core/pdf.py`` and ``core/utilities.py`` frozen."""
    import datetime as dt

    from pylinac_tpu_torch.core import pdf as tpdf
    from pylinac_tpu_torch.core import utilities as tutil

    class Frozen(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2024, 5, 6, 7, 8, 9)

    saved = tpdf.datetime, tutil.datetime
    tpdf.datetime = tutil.datetime = Frozen
    try:
        obj.publish_pdf(f"{tmp}/{tag}.pdf", notes="chip smoke")
        obj.to_quaac(f"{tmp}/{tag}.json", overwrite=True)
        plotly = {k: json.loads(f.to_json())
                  for k, f in obj.plotly_analyzed_images(show=False).items()}
    finally:
        tpdf.datetime, tutil.datetime = saved
    with open(f"{tmp}/{tag}.pdf", "rb") as f:
        pdf = f.read()
    with open(f"{tmp}/{tag}.json") as f:
        quaac = json.load(f)
    return {"pdf": pdf, "quaac": quaac, "plotly": plotly}


def report_tol(path: str, a: float) -> float:
    return max(MM_TOL, 1e-3 * abs(a))


def check_reports(card_obj, cpu_obj, tmp: str, what: str) -> None:
    """The reports of the card's analysis against the CPU's: the PDF
    byte for byte, the QuAAC and plotly JSON keys and strings exact and
    numbers at the parity bar (0.01, or 0.1 % where larger)."""
    import re

    t0 = time.perf_counter()
    got = frozen_reports(card_obj, tmp, "card")
    ms = (time.perf_counter() - t0) * 1e3
    want = frozen_reports(cpu_obj, tmp, "cpu")
    if not got["pdf"].startswith(b"%PDF"):
        raise RuntimeError(f"{what}: the card's PDF is no PDF")
    lines = list(zip(card_obj.results().splitlines(), cpu_obj.results().splitlines()))
    differ = [(a, b) for a, b in lines if a != b]
    if not differ:
        if got["pdf"] != want["pdf"]:
            raise RuntimeError(f"{what}: the card's PDF differs from the CPU's")
        pdf_note = f"PDF {len(got['pdf'])} bytes equal to the CPU's"
    else:
        number = r"-?\d+\.?\d*(?:e[-+]?\d+)?"
        for a, b in differ:
            xa, xb = [float(v) for v in re.findall(number, a)], [float(v) for v in re.findall(number, b)]
            if re.sub(number, "#", a) != re.sub(number, "#", b) or len(xa) != len(xb) or any(
                    abs(u - v) > report_tol("", v) for u, v in zip(xa, xb)):
                raise RuntimeError(f"{what}: the card's results text {a!r} against {b!r}")
        pdf_note = (f"PDF not byte-equal: its results text differs from the CPU's in "
                    f"{len(differ)} lines, each at the bar: {differ}")
    diffs = [compare_tree(got[k], want[k], f"{what} {k}", report_tol) for k in ("quaac", "plotly")]
    exact = [k for k in ("quaac", "plotly") if json.dumps(got[k]) == json.dumps(want[k])]
    inexact = {g["name"]: g["measurement_value"] - w["measurement_value"]
               for g, w in zip(got["quaac"]["datapoints"], want["quaac"]["datapoints"])
               if g["measurement_value"] != w["measurement_value"]}
    print(f"{what} reports on the card: {pdf_note}; QuAAC "
          f"{len(got['quaac']['datapoints'])} datapoints and plotly figures "
          f"{sorted(got['plotly'])} at the bar (max |diff| {max(diffs):.3e}; text-equal: "
          f"{exact or 'none'}; QuAAC card - CPU where not equal: {inexact}); PDF, QuAAC and "
          f"plotly of the card's analysis in {ms:.1f} ms")


def mesh_reports_phase(card: str, median, ccl, flood, gamma2d) -> list[dict]:
    """The multi-device path and the main path's reports. On ``make_mesh()``
    and on logical 4- and 3-shard meshes of the one card: the PF batch of
    64 frames and the CatPhan batch of 4 scans (kept from their phases),
    the FA batch of 64 frames, the gamma batch of 16 pairs and WL centroids
    of the bench's 8 frames (on the even meshes; 8 frames do not split into
    3), each against its unsharded card run, every kernel input held to its
    twin, the launches counted and the warm runs timed. Then the PDF, QuAAC
    and plotly reports of a single spiked PF frame and of a CatPhan504 scan
    analysed on the card, against the CPU's. Returns the kernels-line
    entries ``median3x3_mesh``, ``ccl_label_mesh``, ``ccl_holes_mesh``,
    ``flood_mesh`` and ``gamma2d_mesh``."""
    from pylinac_tpu_torch import FieldAnalysisBatch, PicketFence
    from pylinac_tpu_torch.core import image as timage
    from pylinac_tpu_torch.ops import gamma as tgamma
    from pylinac_tpu_torch.ops import label as tlabel
    from pylinac_tpu_torch.ops import picket_pipeline
    from pylinac_tpu_torch.parallel import mesh as tmesh

    layouts = mesh_layouts()
    lines = []
    median_pairs = {"median": (median.median3x3, median.median3x3_reference)}
    median_bound = lambda x, args: bound(8 * x.numel(), 21 * x.numel(), F32_INSTR_PER_S)

    pf = KEPT["pf_batch"]

    def pf_run(**kw):
        pf.analyze(tolerance=0.5, **kw)
        return {k: v.copy() for k, v in pf._out.items()}

    runs = mesh_runs(card, f"PicketFenceBatch of {len(pf.images)} frames", layouts,
                     lambda: pf_run(device="cuda"), lambda m: pf_run(mesh=m), 1e-5,
                     [(picket_pipeline, "median3x3", "median")], {"median": median.median3x3},
                     {"median": 1})
    lines.append(mesh_kernel_line(card, "median3x3_mesh", "pylinac_tpu_torch/csrc/median3x3.cu",
                                  "pylinac_tpu/ops/pallas_median.py:27", "median", runs,
                                  median_pairs, median_bound))

    ct_batch = KEPT["ct_batch"]

    def ct_run(**kw):
        for scan in ct_batch.cts:
            scan._slice_centroids = None
        ct_batch.analyze(**kw)
        return ({"centroids": np.asarray([c if c is not None else (np.inf, np.inf)
                                          for scan in ct_batch.cts
                                          for c in scan._slice_centroids], np.float64)},
                ct_batch.results_data(as_dict=True))

    def ct_hold(got, want, what):
        held = hold_mesh_result(got[0], want[0], f"{what} slice centroids", PX_TOL)
        if results_text(got[1]) == results_text(want[1]):
            return f"slice centroids {held}, results_data() equal character for character"
        worst = max(compare_tree(g, w, what, ct_tol) for g, w in zip(got[1], want[1]))
        return (f"slice centroids {held}, results_data() within {worst:.3e} at ct_tol "
                f"(not character-equal)")

    runs = mesh_runs(card, f"CatPhanBatch of {len(ct_batch.cts)} scans", layouts,
                     lambda: ct_run(device="cuda"), lambda m: ct_run(mesh=m), ct_hold,
                     ccl_entries(), {"label": ccl.label_batch, "holes": ccl.hole_roots_batch},
                     {"label": 1, "holes": 1})
    pairs = kernel_pairs(ccl)
    for mode in ("label", "holes"):
        lines.append(mesh_kernel_line(card, f"ccl_{mode}_mesh", "pylinac_tpu_torch/csrc/ccl.cu",
                                      "pylinac_tpu/ops/pallas_label.py:336", mode, runs, pairs,
                                      lambda x, args: ccl_bound(x)))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        paths = make_fields(tmp)
        fa = FieldAnalysisBatch([paths[i % FA_FILES] for i in range(FA_FRAMES)], device="cuda")

        def fa_run(**kw):
            fa.analyze(**kw)
            return fa._out

        mesh_runs(card, f"FieldAnalysisBatch of {FA_FRAMES} frames (strips; no kernel)",
                  layouts, lambda: fa_run(device="cuda"), lambda m: fa_run(mesh=m), 1e-5, [], {},
                  {})

        refs, evals = gamma_pairs()
        kw = dict(dose_to_agreement=GAMMA_DOSE_TA, distance_to_agreement=GAMMA_DTA,
                  gamma_cap_value=GAMMA_CAP, global_dose=True, dose_threshold=GAMMA_THRESH)
        runs = mesh_runs(card, f"gamma_2d_batch of {GAMMA_PAIRS} pairs", layouts,
                         lambda: tgamma.gamma_2d_batch(refs, evals, device="cuda", **kw),
                         lambda m: tgamma.gamma_2d_batch(refs, evals, mesh=m, **kw),
                         GAMMA_CPU_TOL, [(tgamma, "gamma2d", "gamma")], {"gamma": gamma2d.gamma2d},
                         {"gamma": 1})

        def gamma_bound(ref_n, args):
            eval_p, dta = args[0], args[1]
            n_offsets = len(gamma2d.offset_table(dta)[1])
            return bound(4 * (2 * ref_n.numel() + eval_p.numel()),
                         4 * n_offsets * ref_n.numel(), F32_INSTR_PER_S)

        lines.append(mesh_kernel_line(card, "gamma2d_mesh", "pylinac_tpu_torch/csrc/gamma2d.cu",
                                      "pylinac_tpu/ops/pallas_gamma.py:27", "gamma", runs,
                                      {"gamma": (gamma2d.gamma2d, gamma2d.gamma2d_reference)},
                                      gamma_bound))

        os.makedirs(f"{tmp}/wl")
        wl_dir = write_session(f"{tmp}/wl")
        frames = np.stack([timage.load(f"{wl_dir}/{f}").array
                           for f in sorted(os.listdir(wl_dir))]).astype(np.float32)
        even = {n: m for n, m in layouts.items() if WL_FRAMES % m.shape["data"] == 0}
        one = layouts["make_mesh()"]
        try:
            tmesh.sharded_wl_centroids(frames, layouts["3 x cuda:0"])
        except ValueError:
            pass
        else:
            raise RuntimeError("sharded_wl_centroids split 8 frames into 3 shards")
        def wl_hold(got, want, what):
            cols = (got - want).abs().amax(dim=0).tolist()
            return (f"{hold_mesh_result(got, want, what, WL_PX_TOL)}, max |diff| by column "
                    f"(field y, field x, BB y, BB x) {cols}")

        runs = mesh_runs(card, f"sharded_wl_centroids of {WL_FRAMES} frames {frames.shape[1:]}",
                         even, lambda: tmesh.sharded_wl_centroids(frames, one),
                         lambda m: tmesh.sharded_wl_centroids(frames, m), wl_hold,
                         [(tlabel, "flood_from_border_batch", "flood")],
                         {"flood": flood.flood_from_border_batch}, {"flood": 1})
        cents = tmesh.sharded_wl_centroids(frames, even["4 x cuda:0"])
        cpu = tmesh.sharded_wl_centroids(frames, tmesh.Mesh([torch.device("cpu")] * 4,
                                                            ("data",)))
        err = float((cents.cpu() - cpu).abs().max())
        if err > WL_PX_TOL:
            raise RuntimeError(f"WL centroids card against CPU: {err} px")
        print(f"sharded_wl_centroids card against CPU: within {err:.2e} px (bar {WL_PX_TOL}); "
              f"field centre {cents[0, :2].tolist()}, BB {cents[0, 2:].tolist()}")
        print(f"[{card}] sharded_wl_centroids on 4 shards: "
              + wl_split_report(frames, cents, tmesh.sharded_wl_centroids(frames, one), 4))
        lines.append(mesh_kernel_line(card, "flood_mesh", "pylinac_tpu_torch/csrc/flood.cu",
                                      "pylinac_tpu/ops/pallas_label.py:165", "flood", runs,
                                      kernel_pairs(ccl, flood),
                                      lambda x, args: flood_bound(x, "flood")))

        pf_path = make_pf_singles(tmp)[1]
        pf_card, pf_cpu = PicketFence(pf_path, device="cuda"), PicketFence(pf_path, device="cpu")
        pf_card.analyze(tolerance=0.5)
        pf_cpu.analyze(tolerance=0.5)
        check_reports(pf_card, pf_cpu, tmp, "single PicketFence (spiked frame, 0.4 mm picket)")
        ct_card, ct_cpu = KEPT["catphan504"]
        check_reports(ct_card, ct_cpu, tmp, "CatPhan504 scan 0")
        try:
            import matplotlib  # noqa: F401
            print("matplotlib imports here: the reports' plots can draw")
        except ImportError:
            try:
                pf_card.plot_analyzed_image(show=False)
            except ModuleNotFoundError as e:
                print(f"matplotlib is missing here: plot_analyzed_image raised {e!r}")
            else:
                raise RuntimeError("plot_analyzed_image drew without matplotlib")
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
    print(f"FieldAnalysis phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    starshot_phase(card)
    print(f"Starshot phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pf_launches, pf_err = pf_single_phase(card, median)
    kernels[0]["launches"] += pf_launches
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], pf_err)
    print(f"single PicketFence phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    codec_checks(card)
    kernels += catphan700_phase(card, ccl)
    print(f"CatPhan 700 phase, the codec checks with it: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += wl_cbct_phase(card, ccl)
    print(f"Winston-Lutz from CBCT phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vmat_phase(card)
    print(f"VMAT phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dlg_phase(card)
    print(f"DLG phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    q_launches, q_err, q_lines = quart_phase(card, median, ccl)
    kernels[0]["launches"] += q_launches
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], q_err)
    kernels += q_lines
    print(f"Quart DVT phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s_launches, s_err, s_lines = ct_siblings_phase(card, ccl, flood)
    single_flood = next(k for k in kernels if k["name"] == "flood_from_border_single")
    single_flood["launches"] += s_launches
    single_flood["max_abs_err"] = max(single_flood["max_abs_err"], s_err)
    kernels += s_lines
    print(f"ACR, cheese and Helios phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    p_launches, p_err, p_lines = planar_phase(card, median, ccl)
    kernels[0]["launches"] += p_launches
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], p_err)
    kernels += p_lines
    print(f"planar imaging and field profile phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += nuclear_phase(card, ccl)
    print(f"nuclear medicine phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels[0]["launches"] += log_phase(card, median)
    print(f"machine log phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += plan_phase(card, median, ccl)
    print(f"plan, contrib and calibration phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += mesh_reports_phase(card, median, ccl, flood, gamma2d)
    KEPT.clear()
    print(f"mesh and reports phase: {time.perf_counter() - t0:.1f} s")
    # last: its profile of an 8-frame run (177,000 launches) left the next
    # phase's profiler with no device events
    t0 = time.perf_counter()
    kernels += mtmf_phase(card, ccl)
    print(f"multi-target Winston-Lutz phase: {time.perf_counter() - t0:.1f} s; whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
