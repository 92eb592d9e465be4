#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``pylinac_tpu_torch/csrc``, checks it
bit for bit against its plain PyTorch twin, runs the batched picket fence
(``PicketFenceBatch``) on 64 EPID-like 1254x1254 uint16 frames on the card,
checks the results and holds them against the port's CPU run, then times
the batch and the kernel. Every failure raises and exits non-zero. The last
line of standard output is one JSON object with ``"ok": true``; the line
before it lists each kernel with its launch count on the main path, its
error against the twin and both times.

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and
``nvidia-smi``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FRAMES = 64
N_FILES = 4
OFFSET_FILE = 1           # paths[1] has picket 3 moved by OFFSET_MM
OFFSET_MM = 0.4
MM_TOL = 0.01             # BASELINE.json parity bar
PCT_TOL = 0.1
KERNEL_SHAPES = [(N_FRAMES, 1254, 1254), (1, 1, 1), (1, 2, 3), (3, 37, 129), (1, 1280, 1280)]


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


def time_kernel(median, x: torch.Tensor) -> tuple[float, float]:
    """Mean ms per call of the kernel and of its twin, timed with CUDA events
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
        fn = median.median3x3_reference if which == "plain" else median.median3x3
        times[which].append(run(fn, 5 if which == "plain" else 50))
    return statistics.mean(times["kernel"]), statistics.mean(times["plain"])


def main() -> int:
    card = card_line()
    print(card)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from pylinac_tpu_torch import PicketFenceBatch
    from pylinac_tpu_torch.ops import _build, median

    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    path, seconds, log = _build.build(median.KERNEL)
    print(f"build {path.name}: {seconds:.2f} s" + ("" if seconds else " (already built)"))
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    max_abs_err = check_kernel(median)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
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
            raise RuntimeError("the main path launched no median3x3 kernel")
        print(f"main path: median3x3.launches = {launches}")
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
        kernel_ms, plain_ms = time_kernel(median, frames)
        print(f"[{card}] median3x3 at {tuple(frames.shape)}: kernel {kernel_ms:.4f} ms, "
              f"plain twin {plain_ms:.3f} ms")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "median3x3", "route": "cuda",
        "source": "pylinac_tpu_torch/csrc/median3x3.cu",
        "replaces": "pylinac_tpu/ops/pallas_median.py:27",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
