#!/usr/bin/env python3
"""Time the port's 3x3-median and gamma CUDA kernels against another
version of the same sources on one card, in turns (old, new, new, old).

    python3 scripts/torch_kernel_ab.py OLD_ROOT [--out DIR]

``OLD_ROOT`` is the root of another checkout of this repository (for
example a ``git archive`` of the parent commit, unpacked). Its
``pylinac_tpu_torch/csrc/{median3x3,gamma2d}.cu`` are built with the same
``nvcc`` flags as this checkout's, and both versions run on the same inputs
at the picket fence and gamma paths' shapes: the median on (64, 1254, 1254)
integer-valued float32 frames, gamma on the bench's 16 pairs of 768 x 1024
(and pair 0 alone) at DTA 9, 3 % global dose, normalised and edge-padded as
``gamma_2d`` does. Each kernel's outputs must be equal between the versions
(NaN where NaN) before any time counts. Times are the mean ms per launch
over 50 (median) or 20 (gamma) launches between CUDA events, after a
warm-up. Prints one line per measurement, the card's name and power limit,
and one JSON object last; with ``--out`` it also writes the JSON and each
library's SASS (``cuobjdump -sass``) with its instruction counts by opcode
into ``DIR``. Needs one CUDA device and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (GAMMA_CAP, GAMMA_DOSE_TA, GAMMA_DTA, GAMMA_THRESH,  # noqa: E402
                        card_line, gamma_pairs)
from pylinac_tpu_torch.ops import _build, gamma2d, median  # noqa: E402


def build(source: Path, out_dir: Path) -> Path:
    """``source`` compiled with the port's flags into ``out_dir``."""
    out_dir.mkdir(exist_ok=True)
    lib = out_dir / f"lib{source.stem}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {source.parent.parent.parent.name}/{source.name}: {line.strip()}")
    return lib


def median_fn(lib: Path):
    fn = ctypes.CDLL(str(lib)).median3x3_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), out.data_ptr(), *x.shape, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"median launch failed: {err}")
        return out
    return run


def gamma_fn(lib: Path, source: Path):
    """A launcher of either C interface: the row table (``n_dist2`` in the
    signature) or the earlier flat offset table of (dy, dx) pairs."""
    fn = ctypes.CDLL(str(lib)).gamma2d_f32
    rows_interface = "n_dist2" in source.read_text()
    n_ints = 6 if rows_interface else 5
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * n_ints + [ctypes.c_float] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    @functools.cache
    def tables(dta):
        table, dist2 = (gamma2d.row_table if rows_interface else gamma2d.offset_table)(dta)
        counts = (len(table), len(dist2)) if rows_interface else (len(dist2),)
        return torch.from_numpy(table.copy()).cuda(), torch.from_numpy(dist2.copy()).cuda(), counts

    def run(ref_n, eval_p, dta, cap, threshold, fill):
        table, dist2, counts = tables(dta)
        out = torch.empty_like(ref_n)
        err = fn(ref_n.data_ptr(), eval_p.data_ptr(), table.data_ptr(), dist2.data_ptr(),
                 out.data_ptr(), *counts, *ref_n.shape, dta, cap, threshold, fill,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gamma launch failed: {err}")
        return out
    return run


def time_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def ab(what: str, old, new, n: int) -> dict:
    """Old and new timed in turns: old, new, new, old."""
    got_old, got_new = old(), new()
    torch.cuda.synchronize()
    if not same(got_old, got_new):
        raise RuntimeError(f"{what}: the two versions disagree")
    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        times[which].append(time_ms(old if which == "old" else new, n))
    print(f"{what}: old {', '.join(f'{t:.4f}' for t in times['old'])} ms, new "
          f"{', '.join(f'{t:.4f}' for t in times['new'])} ms (outputs equal)")
    return {"what": what, "old_ms": times["old"], "new_ms": times["new"],
            "old_mean_ms": statistics.mean(times["old"]),
            "new_mean_ms": statistics.mean(times["new"])}


def sass(lib: Path, out: Path) -> dict:
    """The library's SASS into ``out``; instruction counts by opcode for
    each kernel function."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out.write_text(text)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            counts[name][m.group(1).split(".")[0]] += 1
    return {k: dict(v.most_common()) for k, v in counts.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old_root", type=Path)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    card = card_line()
    print(card)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sources = {(ver, name): root / "pylinac_tpu_torch" / "csrc" / f"{name}.cu"
               for ver, root in (("old", args.old_root), ("new", ROOT))
               for name in ("median3x3", "gamma2d")}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {key: build(src, Path(tmp) / key[0]) for key, src in sources.items()}
        results = []
        gen = torch.Generator(device="cuda").manual_seed(0)
        frames = torch.randint(0, 4096, (64, 1254, 1254), generator=gen,
                               device="cuda").to(torch.float32)
        med = {ver: median_fn(libs[(ver, "median3x3")]) for ver in ("old", "new")}
        results.append(ab("median3x3 at (64, 1254, 1254)", lambda: med["old"](frames),
                          lambda: med["new"](frames), 50))
        if not torch.equal(med["new"](frames), median.median3x3_reference(frames)):
            raise RuntimeError("the new median differs from its twin")

        refs, evals = gamma_pairs()
        ref = torch.from_numpy(refs.astype(np.float32)).cuda()
        ev = torch.from_numpy(evals.astype(np.float32)).cuda()
        gam = {ver: gamma_fn(libs[(ver, "gamma2d")], sources[(ver, "gamma2d")])
               for ver in ("old", "new")}
        dta = GAMMA_DTA
        for batch in (slice(None), slice(0, 1)):
            r, e = ref[batch], ev[batch]
            dose = GAMMA_DOSE_TA / 100 * r.amax()
            ref_n = (r / dose).contiguous()
            eval_p = torch.nn.functional.pad((e / dose)[:, None], (dta,) * 4,
                                             mode="replicate")[:, 0].contiguous()
            kw = (dta, float(GAMMA_CAP), float(np.float32(GAMMA_THRESH / 100)), float("nan"))
            results.append(ab(f"gamma2d at {tuple(ref_n.shape)} dta {dta}",
                              lambda: gam["old"](ref_n, eval_p, *kw),
                              lambda: gam["new"](ref_n, eval_p, *kw), 20))
            if not same(gam["new"](ref_n, eval_p, *kw),
                        gamma2d.gamma2d_reference(ref_n, eval_p, *kw)):
                raise RuntimeError("the new gamma differs from its twin")
        report = {"card": card, "device": torch.cuda.get_device_name(0), "results": results}
        if args.out:
            args.out.mkdir(parents=True, exist_ok=True)
            report["sass_opcodes"] = {f"{ver}/{name}": sass(lib, args.out / f"{ver}_{name}.sass")
                                      for (ver, name), lib in libs.items()}
            (args.out / "ab.json").write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps({k: v for k, v in report.items() if k != "sass_opcodes"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
