"""Stage timings, a launch counter and a device trace.

Port of ``pylinac_tpu/profiling.py`` (``:1-192``): :class:`StageTimings`,
:func:`collect` and :func:`stage` keep their semantics; :func:`stage` is a
no-op outside :func:`collect`, so the analyses call it always. Usage::

    from pylinac_tpu_torch import profiling

    with profiling.collect() as times:
        CatPhan504(folder).analyze(device="cuda")
    print(times.report())          # stage table: ms and share

    with profiling.device_trace("trace_dir"):   # Chrome trace (Perfetto)
        batch.analyze(device="cuda")

    with profiling.count_dispatches() as counts:
        batch.analyze(device="cuda")
    print(counts.as_dict())

Where JAX blocks on its ``sync_args`` (``jax.block_until_ready``, ``:87-90``)
the port synchronises each CUDA device among the tensors of ``sync_args``
(nested in lists, tuples and dicts); with no ``sync_args`` it does not
synchronise, as JAX does not.

The stage names sit at the JAX package's places: the 25 of ``ct.py``
(CatPhan, ``CatPhanBatch`` and, through ``CatPhanBase``, the CT siblings)
and five of the six of ``picketfence.py``'s ``PicketFenceBatch.analyze``.
Not ported: ``pf.spec``, which times the packed wire's tree spec
(``ops/pack.py``, left out of the port with the wire); ``pf.fetch_unpack``
wraps the port's fetch of the output tensors, which the wire's unpack
followed in JAX. The two stages of ``parallel/mesh.py:383-388``,
``bucket+pad`` and ``sharded_compute``, sit in the port's
``QABatchRunner.run``. Shards that run on threads of their own (one a
device) may enter stages too: every entry is recorded.

:func:`count_dispatches` runs ``torch.profiler`` around its block and counts
the CUDA runtime's kernel launches (``dispatches``) and its host-device
copies (``transfers``, from the copies' device records, by direction), each
under ``"cuda"``; to these it adds the hand-written kernels' own launch
counters (``kernels``: ``median3x3``, ``label_batch``, ...). It is a
budgeting tool, off the hot path.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class StageTimings:
    """Accumulated per-stage wall times (seconds), in call order."""

    stages: list[tuple[str, float]] = field(default_factory=list)

    def add(self, name: str, seconds: float) -> None:
        self.stages.append((name, seconds))

    def total(self) -> float:
        return sum(t for _n, t in self.stages)

    def as_dict(self) -> dict[str, float]:
        """Stage -> summed seconds (stages hit several times are summed)."""
        out: dict[str, float] = {}
        for name, t in self.stages:
            out[name] = out.get(name, 0.0) + t
        return out

    def report(self) -> str:
        agg = self.as_dict()
        total = self.total() or 1e-12
        width = max((len(n) for n in agg), default=5)
        lines = [f"{'stage':<{width}}  {'ms':>9}  {'%':>5}"]
        for name, t in agg.items():
            lines.append(f"{name:<{width}}  {t * 1e3:9.2f}  {100 * t / total:5.1f}")
        lines.append(f"{'total':<{width}}  {total * 1e3:9.2f}  100.0")
        return "\n".join(lines)


_active: list[StageTimings] = []


@contextlib.contextmanager
def collect():
    """Activate stage collection; yields the :class:`StageTimings`."""
    timings = StageTimings()
    _active.append(timings)
    try:
        yield timings
    finally:
        _active.remove(timings)


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (lists, tuples, dicts)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, out)
    return out


@contextlib.contextmanager
def stage(name: str, *sync_args):
    """Time a pipeline stage. No-op unless inside :func:`collect`.

    ``sync_args``: tensors (or lists, tuples, dicts of them) whose CUDA
    devices are synchronised before the clock stops, so that queued device
    work is charged to its own stage and not to whoever synchronises next.
    """
    if not _active:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync_args:
            for device in _cuda_devices(sync_args, set()):
                torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        for timings in _active:
            timings.add(name, dt)


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` with CPU and CUDA activities around a block; the
    Chrome trace (``chrome://tracing``, Perfetto) goes to
    ``log_dir/trace.json``."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class DispatchCounts:
    """Kernel launches and host-device copies, keyed by platform, and the
    hand-written kernels' launches, keyed by wrapper."""

    dispatches: dict[str, int] = field(default_factory=dict)
    transfers: dict[str, int] = field(default_factory=dict)
    kernels: dict[str, int] = field(default_factory=dict)

    def add(self, kind: str, platform: str, n: int = 1) -> None:
        d = self.dispatches if kind == "dispatch" else self.transfers
        d[platform] = d.get(platform, 0) + n

    def accelerator_dispatches(self) -> int:
        return sum(n for p, n in self.dispatches.items() if p != "cpu")

    def as_dict(self) -> dict:
        return {"dispatches": dict(self.dispatches),
                "transfers": dict(self.transfers),
                "kernels": dict(self.kernels)}


# the CUDA runtime and driver calls that launch a kernel
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                 "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")


def _wrappers() -> dict:
    """The hand-written kernels' wrappers, each with a ``launches`` count."""
    from .ops import ccl, flood, gamma2d, median

    return {"median3x3": median.median3x3, "label_batch": ccl.label_batch,
            "hole_roots_batch": ccl.hole_roots_batch,
            "flood_from_border_batch": flood.flood_from_border_batch,
            "filled_centroid_batch": flood.filled_centroid_batch, "gamma2d": gamma2d.gamma2d}


@contextlib.contextmanager
def count_dispatches():
    """Count kernel launches and host-device copies within the block.

    Yields a :class:`DispatchCounts`, filled when the block ends: under
    ``"cuda"``, the runtime's launch calls that ``torch.profiler`` recorded
    and its host-to-device and device-to-host copies; under ``kernels``,
    each hand-written wrapper's launches. A budgeting tool, off the hot
    path: the profiler costs time of its own."""
    from torch.profiler import profile

    counts = DispatchCounts()
    wrappers = _wrappers()
    before = {name: fn.launches for name, fn in wrappers.items()}
    with profile(activities=_activities()) as prof:
        yield counts
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    names = [event.name for event in prof.events()]
    launches = sum(name in _LAUNCH_CALLS for name in names)
    copies = sum(name.startswith("Memcpy") and ("HtoD" in name or "DtoH" in name)
                 for name in names)
    if launches:
        counts.add("dispatch", "cuda", launches)
    if copies:
        counts.add("transfer", "cuda", copies)
    counts.kernels = {name: fn.launches - before[name] for name, fn in wrappers.items()
                      if fn.launches != before[name]}
