#!/usr/bin/env python3
"""The ACR mammography phantom of ``chip_smoke.py``'s planar phase at its
full size (2560 x 3328 at 0.07 mm, ``chip_smoke.draw_mammo``) on the card
and on the CPU, compared field by field at the smoke's planar bars, with
the wall time of each run.

    python3 scripts/planar_mammo_cpu.py

Builds the 3x3-median and CCL kernels, analyses the frame once on the card
(``analyze(device="cuda")``, then a second run timed) and once with
``device="cpu"`` (every kernel's plain twin, torch's default CPU threads),
and holds each fibre ROI's ``binary_closing`` input on the card against the
CPU closing of the same mask. Prints the card's name and power limit, one
line per step and one JSON object last. Needs one CUDA device and ``nvcc``;
imports nothing of JAX.

One stated exception to the smoke's bars: the fibres' lengths (mm, so the
mm bar) and orientations. Their masks are equal on both devices, but
``regionprops`` adds the region moments exactly in float64 on the card and
in float32 pixel after pixel on the CPU, as JAX does; in a 279 x 279 px
fibre window the second-moment sums pass 2**24 and the CPU's lose bits,
which the central moments' cancellation magnifies. The script shows it on
each fibre's closed mask, ``regionprops`` of the same mask on both devices.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FIBRE_ORIENTATION_DEG = 0.01   # the stated exception (module docstring)


def tol(path: str, a: float) -> float:
    if path.endswith("/fiber_length"):
        return cs.MM_TOL
    if path.endswith("/fiber_orientation"):
        return FIBRE_ORIENTATION_DEG
    return cs.planar_tol(path, a)


def largest_diffs(a, b, path: str = "") -> dict:
    """The largest |card - CPU| of each float key, over the result tree."""
    out = {}
    if isinstance(a, dict):
        items = [(a[k], b[k], k) for k in a]
    elif isinstance(a, (list, tuple)):
        items = [(x, y, path) for x, y in zip(a, b)]
    elif isinstance(a, float):
        return {path: abs(a - b)}
    else:
        return {}
    for x, y, key in items:
        for k, v in largest_diffs(x, y, key).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def main() -> int:
    card = cs.card_line()
    print(card)
    if not torch.cuda.is_available():
        print("planar_mammo_cpu: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import pylinac_tpu_torch as p
    from pylinac_tpu_torch import planar_imaging as tplanar
    from pylinac_tpu_torch.ops import ccl, median
    from pylinac_tpu_torch.ops import label as tlabel
    from pylinac_tpu_torch.ops import morphology as tmorph

    cs.build_all([median.KERNEL, ccl.KERNEL])
    tmp = tempfile.mkdtemp(prefix="planar_mammo_cpu_")
    try:
        path = cs.draw_mammo(os.path.join(tmp, "mammo.dcm"), cs.MAMMO_DPMM, cs.MAMMO_SHAPE)
        kw = {"invert": False, "low_contrast_visibility_threshold": 400,
              "speck_group_visibility_threshold": cs.MAMMO_SPECK_VISIBILITY}

        def run(device):
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                obj = p.ACRDigitalMammography(path)
                obj.analyze(device=device, **kw)
                data = cs.result_dict(obj)
            if device == "cuda":
                torch.cuda.synchronize()
            return data, (time.perf_counter() - t0) * 1e3

        with cs.recording_inputs([(tplanar, "binary_closing", "closing"),
                                  (tlabel, "regionprops", "regions")]) as seen:
            card_data, first_ms = run("cuda")
        closings = [r for r in seen if r[0] == "closing"]
        fibres = [r for r in seen if r[0] == "regions" and r[3].get("K") == 32]
        card_ms = run("cuda")[1]
        cpu_data, cpu_ms = run("cpu")
        diffs = largest_diffs(card_data, cpu_data)
        print("largest card - CPU differences by key: "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(diffs.items()) if v))
        worst = cs.compare_tree(card_data, cpu_data, "mammography 2560 x 3328 card vs CPU", tol)
        cs.same_warnings(card_data, cpu_data, "mammography 2560 x 3328")
        cs.check_planar_results("ACRDigitalMammography", None, card_data, "card mammography")
        for _, mask, args, _ in closings:
            on_card = tmorph.binary_closing(mask, *args).cpu()
            if not torch.equal(on_card, tmorph.binary_closing(mask.cpu(), *args)):
                raise RuntimeError(f"binary_closing at {tuple(mask.shape)}: card != CPU")
        for _, mask, args, kwargs in fibres:
            on_card = tlabel.regionprops(mask, *args, **kwargs)
            on_cpu = tlabel.regionprops(mask.cpu(), *args, **kwargs)
            j = int(torch.argmax(torch.where(on_cpu.valid, on_cpu.major_axis_length, -1.0)))
            print(f"fibre mask {tuple(mask.shape)}, area {int(on_cpu.area[j])}: the same mask's "
                  f"major axis card {on_card.major_axis_length[j].item():.6f} CPU "
                  f"{on_cpu.major_axis_length[j].item():.6f} px, orientation card "
                  f"{on_card.orientation[j].item():.9f} CPU {on_cpu.orientation[j].item():.9f}")
        shapes = sorted({tuple(m.shape) for _, m, _, _ in closings})
        print(f"[{card}] mammography {cs.MAMMO_SHAPE[1]} x {cs.MAMMO_SHAPE[0]}: card first "
              f"{first_ms:.1f} ms, warm {card_ms:.1f} ms; CPU ({torch.get_num_threads()} threads) "
              f"{cpu_ms:.1f} ms; card vs CPU max difference {worst:.2e}; {len(closings)} "
              f"closings at {shapes} equal card vs CPU")
        print(json.dumps({"card": card, "card_first_ms": first_ms, "card_ms": card_ms,
                          "cpu_ms": cpu_ms, "cpu_threads": torch.get_num_threads(),
                          "max_diff": worst, "closings": len(closings),
                          "fibre_length_mm": diffs.get("fiber_length", 0.0),
                          "fibre_orientation_deg": diffs.get("fiber_orientation", 0.0)}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
