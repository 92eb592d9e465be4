"""The port's CT series loaders: eager, lazy and zipped stacks, and CatPhan
from folders and zips, against each other and the JAX package's, on the CPU.

One synthetic CatPhan 504 scan of 60 slices (the port's generator), stored
uncompressed and zipped. Stacks are compared exactly: paths (by name), z
order, metadata and arrays bit for bit; analyses are compared on their
whole ``results_data()`` but the date, exactly.
"""

import json
import shutil
import warnings
import zipfile

import numpy as np
import pytest
import torch

from pylinac_tpu_torch import ct as tct
from pylinac_tpu_torch.core import dcm
from pylinac_tpu_torch.core import image as timage
from pylinac_tpu_torch.imggen.ct import _generate_catphan700, generate_catphan504

STACKS = ("DicomImageStack", "LazyDicomImageStack")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _zip(folder, path) -> str:
    with zipfile.ZipFile(path, "w") as zf:
        for p in sorted(folder.iterdir()):
            zf.write(p, p.name)
    return str(path)


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ct_loaders")
    folder = tmp / "scan"
    generate_catphan504(folder, num_slices=60, slice_thickness_mm=2.5)
    return folder, _zip(folder, tmp / "scan.zip")


def _undated(result: dict) -> str:
    return json.dumps({k: v for k, v in result.items() if k != "date_of_analysis"})


def _signature(stack):
    """(file names, z positions, metadata tags, arrays) of a stack."""
    metas = stack.metadatas
    images = [stack[i] for i in range(len(stack))]
    return ([p.split("/")[-1] for p in (im.path for im in images)],
            [float(m.ImagePositionPatient[2]) for m in metas],
            [(m.SOPInstanceUID, m.SeriesInstanceUID, m.InstanceNumber) for m in metas],
            np.stack([im.array for im in images]))


def test_eager_lazy_and_zip_stacks_agree(scan):
    folder, zipped = scan
    stacks = [timage.DicomImageStack(folder), timage.LazyDicomImageStack(folder),
              timage.DicomImageStack.from_zip(zipped),
              timage.LazyZipDicomImageStack.from_zip(zipped)]
    want = _signature(stacks[0])
    assert len(want[0]) == 60 and want[1] == sorted(want[1])
    for stack in stacks[1:]:
        got = _signature(stack)
        assert got[:3] == want[:3]
        assert got[3].dtype == want[3].dtype
        np.testing.assert_array_equal(got[3], want[3])
        assert stack.slice_spacing == stacks[0].slice_spacing == 2.5
        assert stack.metadata.SOPInstanceUID == stacks[0].metadata.SOPInstanceUID
    # the lazy zip's folder lives as long as its stack
    lazy_zip = stacks[3]
    assert all(p.startswith(lazy_zip._tmp.name) for p in lazy_zip._paths)


@pytest.mark.parametrize("name", STACKS)
def test_stacks_match_jax(scan, name):
    pytest.importorskip("jax")
    from pylinac_tpu.core import image as jimage

    folder, _ = scan
    got = _signature(getattr(timage, name)(folder))
    want = _signature(getattr(jimage, name)(folder))
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("memory_efficient_mode", [False, True])
def test_catphan_from_zip_equals_the_folder_run(scan, memory_efficient_mode):
    folder, zipped = scan
    ref = tct.CatPhan504(str(folder))
    ref.analyze(device="cpu")
    ct = tct.CatPhan504.from_zip(zipped, memory_efficient_mode=memory_efficient_mode)
    assert ct.was_from_zip and not ref.was_from_zip
    assert isinstance(ct.dicom_stack, timage.LazyZipDicomImageStack
                      if memory_efficient_mode else timage.DicomImageStack)
    ct.analyze(device="cpu", zip_after=True)
    # the localisation's cached volume is the eager stack's, bit for bit
    np.testing.assert_array_equal(ct._loc_stage_host()[1], ref._loc_stage_host()[1])
    assert _undated(ct.results_data(as_dict=True)) == _undated(ref.results_data(as_dict=True))


def test_lazy_folder_batch_and_decodes(scan, monkeypatch):
    """A lazy folder through ``CatPhanBatch`` equals the eager run, and an
    analysis decodes the series once (plus the few slices it reads
    alone), not once a pass."""
    folder, _ = scan
    ref = tct.CatPhanBatch([str(folder)])
    ref.analyze(device="cpu")
    lazy = tct.CatPhan504(str(folder), memory_efficient_mode=True)
    assert isinstance(lazy.dicom_stack, timage.LazyDicomImageStack)
    decodes = []
    init = timage.DicomImage.__init__

    def counting(self, *args, **kwargs):
        decodes.append(args[0])
        init(self, *args, **kwargs)

    batch = tct.CatPhanBatch([str(folder)])
    batch.cts = [lazy]  # the batch takes folders; give it the lazy scan
    monkeypatch.setattr(timage.DicomImage, "__init__", counting)
    batch.analyze(device="cpu")
    assert 60 <= len(decodes) < 60 + 15
    assert (_undated(batch.results_data(as_dict=True)[0])
            == _undated(ref.results_data(as_dict=True)[0]))


@pytest.mark.parametrize("lazy", [False, True])
def test_check_uid(scan, tmp_path, lazy):
    """A slice of another series is dropped unless ``check_uid=False``, as
    in the JAX package."""
    pytest.importorskip("jax")
    from pylinac_tpu.core import image as jimage

    folder, _ = scan
    mixed = tmp_path / "mixed"
    shutil.copytree(folder, mixed)
    ds = dcm.dcmread(str(folder / "ct_010.dcm"))
    ds.SeriesInstanceUID = dcm.generate_uid()
    ds.SOPInstanceUID = dcm.generate_uid()
    dcm.dcmwrite(str(mixed / "other.dcm"), ds)
    name = STACKS[lazy]
    for check_uid, n in ((True, 60), (False, 61)):
        got = getattr(timage, name)(mixed, check_uid=check_uid)
        want = getattr(jimage, name)(mixed, check_uid=check_uid)
        assert len(got) == len(want) == n
        assert _signature(got)[:3] == _signature(want)[:3]
    assert tct.CatPhan504(str(mixed), check_uid=False).num_images == 61
    assert tct.CatPhan504(str(mixed), memory_efficient_mode=lazy).num_images == 60


@pytest.mark.parametrize("lazy", [False, True])
def test_too_few_slices_raise_as_jax(scan, tmp_path, lazy):
    pytest.importorskip("jax")
    from pylinac_tpu.ct import CatPhan504 as JaxCatPhan504

    folder, _ = scan
    short = tmp_path / "short"
    short.mkdir()
    for p in sorted(folder.iterdir())[:30]:
        shutil.copy(p, short / p.name)
    zipped = _zip(short, tmp_path / "short.zip")
    for make in (lambda: JaxCatPhan504.from_zip(zipped, memory_efficient_mode=lazy),
                 lambda: tct.CatPhan504.from_zip(zipped, memory_efficient_mode=lazy)):
        with pytest.raises(ValueError, match="minimum number of CT images"):
            make()


def test_scan_that_stops_short_raises_as_jax(tmp_path):
    """A CatPhan 700 whose scan ends before CTP486 (-160 mm)."""
    pytest.importorskip("jax")
    from pylinac_tpu.ct import CatPhan700 as JaxCatPhan700

    _generate_catphan700(tmp_path, num_slices=48, ctp404_z_mm=30, mm_per_pixel=1.0,
                         image_size=256)
    for ct, kwargs in ((JaxCatPhan700(str(tmp_path)), {}),
                       (tct.CatPhan700(str(tmp_path)), {"device": "cpu"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(ValueError, match="physical scan extent"):
                ct.analyze(**kwargs)


def test_not_a_zip_or_folder(tmp_path):
    with pytest.raises(NotADirectoryError):
        tct.CatPhan504(str(tmp_path / "missing"))
    for lazy in (False, True):
        with pytest.raises(FileNotFoundError):
            tct.CatPhan504.from_zip(str(tmp_path / "missing.zip"), memory_efficient_mode=lazy)
