"""The port's stage timings, launch counter and device trace against the
JAX package's ``profiling`` module, on the CPU: ``collect`` and ``stage``
semantics (a no-op outside ``collect``, nested collectors, summed repeats,
synchronisation only on ``sync_args``), the report's text, the stage names
of ``ct.py`` and ``picketfence.py`` read from both packages' sources, and
the stage sequence of one small ``PicketFenceBatch`` analysis in each.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import profiling

REPO = Path(__file__).resolve().parent.parent
STAGE = re.compile(r'profiling\.stage\((f?"[^"]+")')


@pytest.fixture(scope="module")
def jprof():
    pytest.importorskip("jax")
    from pylinac_tpu import profiling as jp

    return jp


def test_stage_is_a_noop_outside_collect(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    with profiling.stage("outside", torch.zeros(3)):
        pass
    assert profiling._active == [] and calls == []


def test_collect_nests_and_sums(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    with profiling.collect() as outer:
        with profiling.stage("a"):
            pass
        with profiling.collect() as inner:
            with profiling.stage("b", torch.ones(2), [torch.ones(1)], {"x": torch.ones(1)}):
                pass
            with profiling.stage("a"):
                pass
    assert [n for n, _ in outer.stages] == ["a", "b", "a"]
    assert [n for n, _ in inner.stages] == ["b", "a"]
    assert list(outer.as_dict()) == ["a", "b"]
    assert outer.as_dict()["a"] == outer.stages[0][1] + outer.stages[2][1]
    assert outer.total() == pytest.approx(sum(t for _, t in outer.stages))
    assert calls == []          # CPU tensors: nothing to synchronise
    assert profiling._active == []


def test_sync_args_name_their_cuda_devices():
    assert profiling._cuda_devices((torch.zeros(1), [torch.zeros(2)], {"k": 3}), set()) == set()


def test_report_matches_jax(jprof):
    stages = [("localize", 0.5), ("ctp404", 0.25), ("localize", 0.125), ("ctp528.mtf", 1e-4)]
    ours, theirs = profiling.StageTimings(), jprof.StageTimings()
    for name, t in stages:
        ours.add(name, t)
        theirs.add(name, t)
    assert ours.report() == theirs.report()
    assert ours.as_dict() == theirs.as_dict()
    assert profiling.StageTimings().report() == jprof.StageTimings().report()


@pytest.mark.parametrize("module,left_out", [("ct.py", set()), ("picketfence.py", {'"pf.spec"'})])
def test_stage_names_at_the_jax_places(module, left_out):
    """The port carries JAX's stage names, as many times each, less the
    stages of code it left out by design (named in its docstring)."""
    theirs = STAGE.findall((REPO / "pylinac_tpu" / module).read_text())
    ours = STAGE.findall((REPO / "pylinac_tpu_torch" / module).read_text())
    assert sorted(ours) == sorted(n for n in theirs if n not in left_out)
    assert len(theirs) == {"ct.py": 25, "picketfence.py": 6}[module]
    doc = profiling.__doc__
    assert all(n.strip('"') in doc for n in left_out)


def test_picket_fence_batch_stage_sequence_matches_jax(tmp_path, jprof):
    from pylinac_tpu.picketfence import PicketFenceBatch as JBatch

    from pylinac_tpu_torch.imggen.layers import GaussianFilterLayer, PerfectFieldLayer
    from pylinac_tpu_torch.imggen.simulators import AS500Image
    from pylinac_tpu_torch.imggen.utils import generate_picketfence
    from pylinac_tpu_torch.picketfence import PicketFenceBatch

    path = str(tmp_path / "pf.dcm")
    generate_picketfence(AS500Image(sid=1500), PerfectFieldLayer, path,
                         final_layers=[GaussianFilterLayer(sigma_mm=1)], pickets=6,
                         picket_spacing_mm=20, picket_width_mm=3)
    ours, theirs = PicketFenceBatch([path, path]), JBatch([path, path])
    with profiling.collect() as t_ours:
        ours.analyze(device="cpu")
        ours.analyze(device="cpu")
    with jprof.collect() as t_theirs:
        theirs.analyze()
        theirs.analyze()
    assert [n for n, _ in t_ours.stages] == [n for n, _ in t_theirs.stages if n != "pf.spec"]
    assert t_ours.stages[0][0] == "pf.host_orient"


def test_dispatch_counts_and_trace_on_the_cpu(tmp_path, jprof):
    x = torch.arange(12.0).reshape(3, 4)
    with profiling.count_dispatches() as counts:
        (x @ x.T).sum()
    assert counts.as_dict().keys() >= jprof.DispatchCounts().as_dict().keys()
    assert counts.accelerator_dispatches() == 0 and counts.kernels == {}
    with profiling.device_trace(str(tmp_path / "trace")):
        np.asarray((x * 2).sum())
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_counts_launches_and_copies(cuda):
    from pylinac_tpu_torch.ops.median import median3x3

    x = torch.rand(2, 64, 64)
    with profiling.count_dispatches() as counts:
        y = median3x3(x.to(cuda)) + 1
        y.cpu()
    assert counts.kernels == {"median3x3": 1}
    assert counts.dispatches["cuda"] >= 1 and counts.transfers["cuda"] >= 2
    with profiling.collect() as times:
        with profiling.stage("median", y):
            median3x3(y)
    assert list(times.as_dict()) == ["median"]
