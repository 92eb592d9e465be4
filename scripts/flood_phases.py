#!/usr/bin/env python3
"""Where the border-flood kernel's time goes, phase by phase, on one card.

    python3 scripts/flood_phases.py [FLOOD_CU ...]

Each ``FLOOD_CU`` (default: this checkout's ``pylinac_tpu_torch/csrc/flood.cu``)
is copied with ``clock64`` stamps patched in: thread 0 of block 0 stamps the
kernel's start, the end of its pack and of the grid barrier after it, the
end of its work and of the barrier in each round, and the kernel's end
(with ``%globaltimer`` at start and end to turn cycles into us). The copy
is built with the port's ``nvcc`` flags. On a WL-like field at (8, 1280,
1280) and (1, 1280, 1280), a 3-turn spiral at (1, 1280, 1280), 3 % speckle
at (8, 1280, 1280) and ring + noise at (416, 134, 134), both entries must
equal their twins bit for bit; then each source is timed in turns (a, b,
..., b, a; mean ms of 50 launches between CUDA events, the wrapper's
allocations included) and one stamped run prints its phases: pack, the
barrier after it, each round's work + barrier, and the epilogue, in us of
block 0's timeline. Block 0's work is one block's; its barrier wait holds
the slowest block's. The sources must be of this kernel's design (one
cooperative launch with a round loop). Needs one CUDA device and ``nvcc``;
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import card_line, ccl_mask  # noqa: E402
from pylinac_tpu_torch.ops import flood  # noqa: E402
from torch_kernel_ab import build as build_library, time_ms  # noqa: E402

PROFILE = r'''
__device__ unsigned long long g_prof[256];
__device__ __forceinline__ void stamp(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) g_prof[i] = clock64();
}
__device__ __forceinline__ void gstamp(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_prof[i] = t;
  }
}
'''
READERS = r'''
extern "C" int read_prof(void* host) { return cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)); }
extern "C" int reset_prof() {
  static unsigned long long z[256];
  return cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''
MAX_ROUNDS = 100  # stamps 3 + 2r and 4 + 2r; 250 and 252-253 are the ends


def _replace(s: str, old: str, new: str, what: str, count: int = 1) -> str:
    if s.count(old) != count:
        raise ValueError(f"cannot place the {what} stamp: {old!r} occurs {s.count(old)} times")
    return s.replace(old, new)


def stamped(source: str) -> str:
    """``source`` with the phase stamps and the two C readers added."""
    s = _replace(source, "namespace {\n", "namespace {\n" + PROFILE, "profile")
    s = _replace(s, "  cg::grid_group grid = cg::this_grid();\n",
                 "  cg::grid_group grid = cg::this_grid();\n  gstamp(252); stamp(0);\n", "start")
    pack = s.index("pack_tile(mask, bg, reached, g, span_of(t, g));")
    at = s.index("grid.sync();", pack)
    s = s[:at] + "stamp(1); grid.sync(); stamp(2);" + s[at + len("grid.sync();"):]
    stamp_round = s.index("atomicMax(state, round + 1);")
    at = s.index("grid.sync();", stamp_round)
    s = (s[:at] + f"if (round < {MAX_ROUNDS}) stamp(3 + 2 * round); grid.sync(); "
         f"if (round < {MAX_ROUNDS}) stamp(4 + 2 * round);" + s[at + len("grid.sync();"):])
    s = _replace(s, "    return;\n  }\n", "    stamp(250); gstamp(253);\n    return;\n  }\n",
                 "flood end")
    last = s.index("centroid[2 * b + 1] =")
    at = s.index("}\n}", last)
    return s[:at] + "}\n  stamp(250); gstamp(253);\n}" + s[at + 3:] + READERS


def build(source: Path, out_dir: Path, tag: str) -> ctypes.CDLL:
    """The stamped copy of ``source`` built into ``out_dir`` and loaded."""
    print(f"{tag}: {source}")
    (out_dir / tag).mkdir()
    cu = out_dir / tag / "flood.cu"
    cu.write_text(stamped(source.read_text()))
    dll = ctypes.CDLL(str(build_library(cu, out_dir / tag)))
    for name in ("flood_from_border_i32", "filled_centroid_f32"):
        fn = getattr(dll, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    dll.read_prof.argtypes = [ctypes.c_void_p]
    return dll


def launch(dll: ctypes.CDLL, masks: torch.Tensor, entry: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of an entry as ``ops/flood.py`` makes it; (output, state
    buffer, whose first word + 1 is the rounds taken)."""
    b, h, w = masks.shape
    bg = torch.empty((b, h, -(-w // 32)), dtype=torch.int32, device=masks.device)
    reached = torch.empty_like(bg)
    centroid = entry == "centroid"
    state = torch.zeros(1 + (3 * b if centroid else 0), dtype=torch.int64, device=masks.device)
    out = (torch.zeros((b, 2), dtype=torch.float32, device=masks.device) if centroid
           else torch.empty(masks.shape, dtype=torch.int32, device=masks.device))
    fn = dll.filled_centroid_f32 if centroid else dll.flood_from_border_i32
    err = fn(masks.data_ptr(), out.data_ptr(), bg.data_ptr(), reached.data_ptr(),
             state.data_ptr(), b, h, w, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flood launch failed: CUDA error {err}")
    return out, state


def phases(dll: ctypes.CDLL, masks: torch.Tensor, entry: str) -> str:
    dll.reset_prof()
    torch.cuda.synchronize()
    _, state = launch(dll, masks, entry)
    torch.cuda.synchronize()
    prof = (ctypes.c_ulonglong * 256)()
    dll.read_prof(ctypes.addressof(prof))
    p = list(prof)
    rounds = int(state[0]) + 1
    ns_per_cycle = (p[253] - p[252]) / max(p[250] - p[0], 1)

    def us(cycles: int) -> str:
        return f"{cycles * ns_per_cycle / 1e3:.1f}"

    parts = [f"pack {us(p[1] - p[0])}", f"barrier {us(p[2] - p[1])}"]
    prev = p[2]
    for r in range(min(rounds, MAX_ROUNDS)):
        parts.append(f"r{r} {us(p[3 + 2 * r] - prev)}+{us(p[4 + 2 * r] - p[3 + 2 * r])}")
        prev = p[4 + 2 * r]
    parts.append(f"epilogue {us(p[250] - prev)}; kernel {(p[253] - p[252]) / 1e3:.1f} us")
    return f"{rounds} rounds: " + " ".join(parts)


def cases() -> dict[str, np.ndarray]:
    yy, xx = np.mgrid[:1280, :1280]
    field = (np.abs(yy - 640) < 45) & (np.abs(xx - 640) < 45)  # a 30 mm field at AS1200
    field[630:650, 630:650] = False                             # the BB's hole
    rng = np.random.default_rng(0)
    return {"WL-like field": np.broadcast_to(field, (8, 1280, 1280)).copy(),
            "WL-like field, one frame": field[None].copy(),
            "3-turn spiral": ccl_mask("spiral", (1, 1280, 1280), rng),
            "3 % speckle": ccl_mask("speckle 3%", (8, 1280, 1280), rng),
            "ring + noise": ccl_mask("ring+noise", (416, 134, 134), rng)}


def main() -> int:
    card = card_line()
    print(card)
    if not torch.cuda.is_available():
        print("flood_phases: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sources = [Path(a) for a in sys.argv[1:]] or [ROOT / "pylinac_tpu_torch" / "csrc" / "flood.cu"]
    with tempfile.TemporaryDirectory() as tmp:
        dlls = [build(src, Path(tmp), f"s{i}") for i, src in enumerate(sources)]
        order = list(range(len(dlls))) + list(reversed(range(len(dlls))))
        for name, mask in cases().items():
            masks = torch.from_numpy(mask).cuda()
            twins = {"flood": flood.flood_from_border_reference(masks),
                     "centroid": flood.filled_centroid_reference(masks)}
            for entry, want in twins.items():
                for i, dll in enumerate(dlls):
                    got, _ = launch(dll, masks, entry)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise RuntimeError(f"s{i} {entry} differs from its twin on {name}")
                times = {i: [] for i in range(len(dlls))}
                for i in order:
                    times[i].append(time_ms(lambda: launch(dlls[i], masks, entry), 50))
                for i, dll in enumerate(dlls):
                    print(f"[{card}] s{i} {entry} on {name} {tuple(masks.shape)}: "
                          f"{', '.join(f'{t:.4f}' for t in times[i])} ms; "
                          f"{phases(dll, masks, entry)}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
